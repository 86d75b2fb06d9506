"""Partition rules and the sharded train step (port of
paddle_tpu/distributed/sharded.py).

The reference attaches `NamedSharding`s to the arrays of the train state
by regex rules and lets GSPMD compile the collectives, so its sharded
step computes the unsharded step's function of the GLOBAL batch.  In the
port each rank holds its own tensors and the step spells the
collectives out:

- `shard_params` / `shard_train_state` keep this rank's block of every
  leaf whose spec splits it (a dim that its axes do not divide stays
  whole: the reference's `_named` clamp); `zero1=True` also splits the
  optimizer moments' dim 0 over dp where it is free (`_zero1_spec`);
- `shard_batch` keeps this rank's block of the batch (dim 0 over dp,
  dim 1 over sp);
- `make_sharded_train_step` runs the model inside
  `tensor_parallel(mesh)` (Megatron tp, the vocab-parallel embedding and
  cross-entropy, the ring over sp: `tensor_parallel.py`) and
  `moe.expert_parallel(mesh)` (the global batch's routing over dp x sp,
  the experts over ep); grads and loss are meaned over dp and sp (equal
  blocks, so the mean over the global tokens); a param split over dp
  (`fsdp_rules()`) is gathered where its module runs
  (`all_gather(grad="sum")`, so its grad is reduce-scattered) and freed
  after it, re-gathered for the backward; `accum_steps=k` accumulates k
  microbatches' grads before the update; a global-norm clip sums the
  squares of split params over the axes they are split on; under zero1
  each rank updates its dp block of a param with its block of the
  moments, and the new params are gathered over dp.

A mesh held in one process (`inprocess.local_meshes`) runs the same
step per rank: `run_local_step(steps, states, batches)`.
"""

import contextlib
import copy
import re
import threading
import weakref

import torch

__all__ = [
    "PartitionSpec", "P", "PartitionRules", "gpt_rules", "bert_rules",
    "mlp_rules", "fsdp_rules", "shard_params", "shard_train_state",
    "shard_batch", "make_sharded_train_step", "ShardedTrainStep",
    "run_local_step", "state_specs", "gather_state", "local_block",
    "fsdp_full",
]


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`'s counterpart: one entry per dim, an
    axis name, a tuple of names, or None (not split)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        # pickle and copy rebuild it from its entries
        return tuple(self)

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


# --- specs on this mesh ------------------------------------------------------

def _names(a):
    return () if a is None else ((a,) if isinstance(a, str) else tuple(a))


def _size(mesh, a):
    n = 1
    for name in _names(a):
        n *= mesh.axis_size(name)
    return n


def _named(mesh, spec, shape):
    """The spec as it splits an array of `shape` on this mesh: entries
    past the rank dropped, a dim that its axes' size does not divide
    left whole, trailing Nones dropped (the reference's `_named`)."""
    parts = list(spec)[:len(shape)]
    parts += [None] * (len(shape) - len(parts))
    parts = [a if shape[i] % _size(mesh, a) == 0 else None
             for i, a in enumerate(parts)]
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _split_dims(mesh, spec):
    """[(dim, axis names)] of a named spec's entries that split."""
    return [(d, _names(a)) for d, a in enumerate(spec)
            if a is not None and _size(mesh, a) > 1]


def _block_index(mesh, names):
    """This rank's block index along a dim split over `names` (the
    first name major, as a tuple entry of a PartitionSpec)."""
    idx = 0
    for name in names:
        idx = idx * mesh.axis_size(name) + mesh.axis_index(name)
    return idx


def local_block(mesh, spec, value):
    """This rank's block of the global `value` under a named spec."""
    for d, names in _split_dims(mesh, spec):
        n = _size(mesh, names)
        blk = value.shape[d] // n
        value = value.narrow(d, _block_index(mesh, names) * blk, blk)
    return value


def _local(mesh, spec, value):
    return local_block(mesh, _named(mesh, spec, tuple(value.shape)), value)


def _gather_block(mesh, spec, value):
    """The global array from this rank's block under a named spec: each
    split dim gathered over its axes, the minor axis first."""
    from .collective import all_gather

    with torch.no_grad():
        for d, names in _split_dims(mesh, spec):
            for name in reversed(names):
                if mesh.axis_size(name) > 1:
                    value = all_gather(value.contiguous(), name, axis=d,
                                       mesh=mesh)
    return value


def _zero1_spec(spec, shape, mesh):
    """Add dp-splitting of dim 0 to an optimizer-moment spec (ZeRO-1):
    a dim-0 axis of size 1 (e.g. "tp" on a pure-DP mesh) counts as
    free; an indivisible dim is left for `_named` to clamp."""
    dp = mesh.axis_size("dp")
    if dp <= 1 or not shape:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if parts and _size(mesh, parts[0]) == 1 and shape[0] % dp == 0:
        parts[0] = "dp"
        return P(*parts)
    return spec


# --- sharding a state --------------------------------------------------------

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


def _slot_spec(mesh, rules, name, p, zero1):
    spec = rules.spec(name, p)
    if zero1:
        spec = _zero1_spec(spec, tuple(p.shape), mesh)
    return _named(mesh, spec, tuple(p.shape))


def state_specs(state, mesh, rules, zero1=False):
    """{checkpoint key: named spec} of every leaf of the GLOBAL
    TrainState `state` that the rules split on this mesh: the params,
    and the optimizer slots shaped like their param (their spec plus
    dp on dim 0 under zero1).  Keys are `checkpoint.flatten_with_path`'s
    (the reference's `keystr`)."""
    out = {}
    for n, p in state.params.items():
        spec = _named(mesh, rules.spec(n, p), tuple(p.shape))
        if _split_dims(mesh, spec):
            out[f".params[{n!r}]"] = spec
        slots = state.opt_state.get(n)
        if isinstance(slots, dict):
            s = _slot_spec(mesh, rules, n, p, zero1)
            if _split_dims(mesh, s):
                for k, t in slots.items():
                    if tuple(t.shape) == tuple(p.shape):
                        out[f".opt_state[{n!r}][{k!r}]"] = s
    return out


def shard_train_state(state, mesh, rules, zero1=False):
    """A models.train.TrainState with its params and their optimizer
    slots cut to this rank's blocks per `rules` (the slots also split
    over dp on dim 0 under `zero1`); buffers, step and rng as they
    are."""
    from ..models.train import TrainState

    params = shard_params(state.params, mesh, rules)
    opt_state = {}
    for n, slots in state.opt_state.items():
        p = state.params.get(n)
        if p is None or not isinstance(slots, dict):
            opt_state[n] = slots
            continue
        spec = _slot_spec(mesh, rules, n, p, zero1)
        opt_state[n] = {
            k: (local_block(mesh, spec, t).clone()
                if tuple(t.shape) == tuple(p.shape) else t)
            for k, t in slots.items()}
    return TrainState(params=params, opt_state=opt_state,
                      buffers=state.buffers, step=state.step, rng=state.rng)


def gather_state(state, mesh, specs):
    """The global state from this rank's sharded one: every leaf named in
    `specs` ({checkpoint key: named spec}, `state_specs`) gathered over
    the axes that split it (a collective: every rank calls it); the
    other leaves as they are."""
    from ..checkpoint import _rebuild

    return _rebuild(state, "", lambda key, leaf: (
        _gather_block(mesh, specs[key], leaf) if key in specs else leaf))


# --- FSDP: params split over dp, gathered where their module runs ------------

_FSDP = threading.local()


class _FsdpScope:
    """The dp-split params of one forward: {param tensor id: (name,
    spec)} of the shards swapped into the model, and the bytes of the
    gathered params alive (`live`, `peak`)."""

    def __init__(self, mesh, shards, pack):
        self.mesh = mesh
        self.shards = shards
        self.pack = pack
        self.live = 0
        self.peak = 0
        self._full = {}

    def _count(self, t):
        n = t.numel() * t.element_size()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live -= n

    def gather(self, t):
        """The whole param of the shard t (differentiable: the grad of
        the whole is reduce-scattered back, summed over dp)."""
        from .collective import all_gather

        _, spec = self.shards[id(t)]
        full = t
        for d, names in _split_dims(self.mesh, spec):
            for axis in reversed(names):
                full = all_gather(full, axis, axis=d, mesh=self.mesh,
                                  grad="sum")
        self._count(full)
        if self.pack:
            # forgotten with the tensor, so that a later tensor at the
            # same address is never taken for it
            key = full.untyped_storage().data_ptr()
            self._full[key] = (t, spec)
            weakref.finalize(full, self._full.pop, key, None)
        return full

    def pack_saved(self, t):
        # a saved view of a gathered param is kept as its shard and
        # gathered again when the backward reads it
        got = self._full.get(t.untyped_storage().data_ptr())
        if got is None or t.dtype != got[0].dtype:
            return t
        return ("fsdp", got[0], got[1], t.size(), t.stride(),
                t.storage_offset())

    def unpack_saved(self, packed):
        if not (isinstance(packed, tuple) and packed
                and packed[0] == "fsdp"):
            return packed
        _, shard, spec, size, stride, offset = packed
        full = _gather_block(self.mesh, spec, shard.detach())
        self._count(full)
        return full.as_strided(size, stride, offset)


def _fsdp_scope():
    stack = getattr(_FSDP, "stack", None)
    return stack[-1] if stack else None


def fsdp_full(t):
    """t, or the whole param when t is a dp shard swapped in by the
    sharded step's FSDP scope (a model reads a table outside its own
    module through this, e.g. the GPT's tied head)."""
    scope = _fsdp_scope()
    if scope is None or id(t) not in scope.shards:
        return t
    return scope.gather(t)


def _fsdp_pre(module, args):
    scope = _fsdp_scope()
    if scope is None:
        return
    swapped = []
    for leaf, t in list(module._parameters.items()):
        if t is not None and id(t) in scope.shards:
            module._parameters[leaf] = scope.gather(t)
            swapped.append((leaf, t))
    module._fsdp_swapped = swapped


def _fsdp_post(module, args, out):
    for leaf, t in getattr(module, "_fsdp_swapped", ()):
        module._parameters[leaf] = t
    module._fsdp_swapped = ()


@contextlib.contextmanager
def _fsdp(mesh, shards, pack):
    stack = getattr(_FSDP, "stack", None)
    if stack is None:
        stack = _FSDP.stack = []
    scope = _FsdpScope(mesh, shards, pack)
    stack.append(scope)
    try:
        if pack:
            with torch.autograd.graph.saved_tensors_hooks(
                    scope.pack_saved, scope.unpack_saved):
                yield scope
        else:
            yield scope
    finally:
        stack.pop()


# --- the step ----------------------------------------------------------------

class ShardedTrainStep:
    """`step(state, *batch) -> (state, loss)` of `make_sharded_train_step`
    (see the module docstring).  Its parts, for a mesh held in one
    process: `forward(state, batch, buffers) -> (loss, leaves,
    buffers)` (one microbatch, this rank's loss; `leaves` the tensors
    the grads are taken against) and `finish(state, loss, grads,
    buffers)` (the reductions over the mesh, the clip and the update).
    `state_specs` names the leaves the rules split (for checkpoints);
    `fsdp_peak_bytes` the most bytes of gathered dp-split params alive
    at once in the last forward and backward."""

    def __init__(self, model, optimizer, mesh, rules, loss_fn, zero1,
                 accum_steps, global_state):
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.model, self.mesh = model, mesh
        self.loss_fn = loss_fn or (lambda m, *b: m.loss(*b))
        self.accum_steps = int(accum_steps)
        self._clip = optimizer._grad_clip
        self._opt = copy.copy(optimizer)
        self._opt._grad_clip = None
        self.param_specs, self.split_axes = {}, {}
        self.fsdp, self.zero1_params = set(), set()
        for n, p in global_state.params.items():
            spec = _named(mesh, rules.spec(n, p), tuple(p.shape))
            axes = tuple(a for _, names in _split_dims(mesh, spec)
                         for a in names if mesh.axis_size(a) > 1)
            bad = [a for a in axes if a in ("sp", "pp")]
            if bad:
                raise ValueError(f"param {n!r} split over {bad}: params "
                                 "split over tp, ep and dp (FSDP) only")
            self.param_specs[n], self.split_axes[n] = spec, axes
            if "dp" in axes:
                self.fsdp.add(n)
            elif zero1 and mesh.axis_size("dp") > 1:
                slot = _slot_spec(mesh, rules, n, p, True)
                if slot and _names(slot[0]) == ("dp",):
                    self.zero1_params.add(n)
        self.state_specs = state_specs(global_state, mesh, rules, zero1)
        self.fsdp_peak_bytes = 0
        self._scope = None
        if self.fsdp:
            owners = {n.rpartition(".")[0] for n in self.fsdp}
            for path, mod in model.named_modules():
                if path in owners and not getattr(mod, "_fsdp_hooked",
                                                  False):
                    mod.register_forward_pre_hook(_fsdp_pre)
                    mod.register_forward_hook(_fsdp_post)
                    mod._fsdp_hooked = True

    def _contexts(self, leaves):
        from .moe import expert_parallel
        from .tensor_parallel import tensor_parallel

        stack = contextlib.ExitStack()
        stack.enter_context(expert_parallel(self.mesh))
        stack.enter_context(tensor_parallel(self.mesh))
        if self.fsdp:
            shards = {id(leaves[n]): (n, self.param_specs[n])
                      for n in self.fsdp}
            inproc = getattr(self.mesh, "world", None) is not None
            self._scope = stack.enter_context(
                _fsdp(self.mesh, shards, pack=not inproc))
        return stack

    def _note_peak(self):
        if self._scope is not None:
            self.fsdp_peak_bytes = max(self.fsdp_peak_bytes,
                                       self._scope.peak)

    def forward(self, state, batch, buffers):
        from ..models.train import _loss_with_buffers

        self._note_peak()
        names = list(state.params)
        leaves = {n: state.params[n].detach().requires_grad_()
                  for n in names}
        with torch.enable_grad(), self._contexts(leaves):
            loss, new_bufs = _loss_with_buffers(
                self.model, leaves, buffers, state.rng, self.loss_fn, batch)
        return loss, [leaves[n] for n in names], new_bufs

    def _micro(self, batch, i):
        k = self.accum_steps
        if k == 1:
            return batch
        for b in batch:
            if b.shape[0] % k:
                raise ValueError(
                    f"batch leading dim {b.shape[0]} not divisible into "
                    f"accum_steps={k} microbatches")
        return tuple(b.reshape(k, b.shape[0] // k, *b.shape[1:])[i]
                     for b in batch)

    def _grads_of(self, state, lists, leaves_grads):
        """{name: grad} of this rank, summed over the microbatches."""
        names = list(state.params)
        for n, g in zip(names, leaves_grads):
            if g is not None:
                lists[n] = g if n not in lists else lists[n] + g
        return lists

    def __call__(self, state, *batch):
        grads, losses, bufs = {}, [], state.buffers
        for i in range(self.accum_steps):
            loss, leaves, bufs = self.forward(state, self._micro(batch, i),
                                              bufs)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = self._grads_of(state, grads, gs)
            losses.append(loss.detach())
        return self.finish(state, losses, grads, bufs)

    def _sumsq(self, grads):
        """The squares of the grads summed over the whole model: a split
        param's over the axes it is split on, a replicated one once."""
        from .collective import all_reduce_

        groups = {}
        for n, g in grads.items():
            groups.setdefault(self.split_axes[n], []).append(g)
        total = None
        for axes in sorted(groups):
            part = sum(torch.sum(torch.square(g.float()))
                       for g in groups[axes])
            for a in axes:
                part = all_reduce_(part.clone(), "sum", self.mesh, a)
            total = part if total is None else total + part
        return total

    def finish(self, state, losses, grads, buffers):
        """Mean the grads and the loss over the microbatches, dp and sp;
        clip; update (zero1: this rank's dp block, then gathered)."""
        from .collective import all_gather, all_reduce_

        self._note_peak()
        mesh, k = self.mesh, self.accum_steps
        loss = losses[0].float()
        for l in losses[1:]:
            loss = loss + l.float()
        loss = loss / k
        dp, sp = mesh.axis_size("dp"), mesh.axis_size("sp")
        out = {}
        for n in state.params:
            g = grads.get(n)
            if g is None:
                continue
            g = g / k if k > 1 else g
            g = g.contiguous()
            if n in self.fsdp:
                g = g / dp          # the gather's backward summed over dp
            elif dp > 1:
                g = all_reduce_(g, "mean", mesh, "dp")
            if sp > 1:
                g = all_reduce_(g, "mean", mesh, "sp")
            out[n] = g
        for a in ("dp", "sp"):
            if mesh.axis_size(a) > 1:
                loss = all_reduce_(loss.clone(), "mean", mesh, a)
        if self._clip is not None:
            if hasattr(self._clip, "clip_norm"):
                out = self._clip(out, sumsq=self._sumsq)
            else:
                out = self._clip(out)
        params, upd_grads = state.params, out
        if self.zero1_params:
            params, upd_grads = dict(params), dict(out)
            i = mesh.axis_index("dp")
            for n in self.zero1_params:
                blk = params[n].shape[0] // dp
                params[n] = params[n].narrow(0, i * blk, blk)
                if n in upd_grads:
                    upd_grads[n] = upd_grads[n].narrow(0, i * blk, blk)
        self._opt.update(params, upd_grads, state.opt_state, inplace=True)
        with torch.no_grad():
            for n in sorted(self.zero1_params):
                state.params[n].copy_(all_gather(params[n].contiguous(),
                                                 "dp", axis=0, mesh=mesh))
            for name, b in buffers.items():
                if b is not state.buffers[name]:
                    state.buffers[name].copy_(b)
            state.step.add_(1)
        return state, loss


def make_sharded_train_step(model, optimizer, mesh, rules=None,
                            loss_fn=None, rng_seed=0, zero1=False,
                            accum_steps=1):
    """Build (step, sharded_state).  step(state, *batch) -> (state,
    loss), where batch holds this rank's blocks (`shard_batch`) and loss
    is the global batch's; see the module docstring for what the step
    computes.  The state's params and slots are this rank's blocks
    (`step.state_specs` names the split ones)."""
    from ..models.train import init_train_state

    rules = rules or gpt_rules()
    model.train()
    state = init_train_state(model, optimizer, rng_seed=rng_seed)
    step = ShardedTrainStep(model, optimizer, mesh, rules, loss_fn, zero1,
                            accum_steps, state)
    return step, shard_train_state(state, mesh, rules, zero1=zero1)


def run_local_step(steps, states, batches):
    """One step of every rank of a mesh held in one process: `steps`,
    `states` and `batches` (tuples of this rank's blocks) per rank, the
    meshes those of `steps`.  The forwards run at once (one thread a
    rank), one backward takes every rank's grads, then the ranks finish
    at once.  Returns [(state, loss)] per rank."""
    from .inprocess import joint_grad, run_ranks

    meshes = [s.mesh for s in steps]
    k = steps[0].accum_steps
    grads = [{} for _ in steps]
    losses = [[] for _ in steps]
    bufs = [st.buffers for st in states]
    for i in range(k):
        outs = run_ranks(meshes, lambda r, m: steps[r].forward(
            states[r], steps[r]._micro(batches[r], i), bufs[r]))
        gs = joint_grad([o[0] for o in outs], [o[1] for o in outs])
        for r, (loss, _, b) in enumerate(outs):
            bufs[r] = b
            losses[r].append(loss.detach())
            grads[r] = steps[r]._grads_of(states[r], grads[r], gs[r])
    return run_ranks(meshes, lambda r, m: steps[r].finish(
        states[r], losses[r], grads[r], bufs[r]))
