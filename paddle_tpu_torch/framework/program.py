"""Program / Block / Variable / Operator graph builder (port of
paddle_tpu/framework/program.py).

Paddle-Fluid's ProgramDesc stack (framework.proto:42-216 and the Python
mirror in fluid/framework.py: Variable :806, Operator :1706, Block :2176,
Program :3602) as a lightweight recorded op list.  The port's Executor
interprets it op by op with eager PyTorch, where the JAX package lowers it
to one jitted function.  The classes, their serialization (`to_json` /
`from_json`, byte-compatible with the JAX package's) and the builder API
are the reference's.
"""

import contextlib
import copy
import json
import os
import sys

import numpy as np

from ..core.dtype import convert_dtype
from . import unique_name

# the port's own directory, with the separator: a frame of paddle_tpu (or
# of any other package whose name starts the same) is a caller's frame
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep


def _user_callsite():
    """First stack frame outside the paddle_tpu_torch package — where the user
    built this op (reference op_call_stack.cc attaches the Python stack
    to op errors). Walks raw frames via sys._getframe — unlike
    traceback.extract_stack this never touches source files, so per-op
    graph-build overhead stays negligible even for large programs."""
    fr = sys._getframe(1)
    depth = 0
    while fr is not None and depth < 24:
        code = fr.f_code
        if not code.co_filename.startswith(_PKG_DIR):
            return f"{code.co_filename}:{fr.f_lineno} ({code.co_name})"
        fr = fr.f_back
        depth += 1
    return None


def did_you_mean(name, candidates, n=3, cutoff=0.6):
    """Difflib close-match suggestion text (" — did you mean ...?") or
    "" when nothing is close.  The ONE fuzzy-suggestion rule: Block.var
    uses it for typo'd var names and the sharding rule engine for rule
    regexes that match zero vars — a typo'd rule gets the same
    treatment a typo'd fetch does."""
    import difflib

    close = difflib.get_close_matches(name, list(candidates), n=n,
                                      cutoff=cutoff)
    if not close:
        return ""
    return " — did you mean " + " or ".join(
        f"'{c}'" for c in close) + "?"


class Variable:
    """A named slot in a Block. Parity: framework.py:806."""

    def __init__(
        self,
        block,
        name=None,
        shape=None,
        dtype="float32",
        persistable=False,
        stop_gradient=False,
        is_data=False,
        lod_level=0,
    ):
        self.block = block
        self.name = name or unique_name.generate("_generated_var")
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype) if dtype is not None else None
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level

    @property
    def persistable(self):
        return self._persistable

    @persistable.setter
    def persistable(self, value):
        # layers toggle persistability on existing vars (plain attribute
        # write); the flip changes the executor's persist-name analysis,
        # so it must bump the program version like any other mutation or
        # a cached run-plan would keep serving the stale persist set
        value = bool(value)
        old = getattr(self, "_persistable", None)
        self._persistable = value
        if old is not None and old != value:
            self.block.program._bump()

    @property
    def is_parameter(self):
        return isinstance(self, Parameter)

    def astype(self, dtype):
        from ..layers import cast

        return cast(self, dtype)

    # Python operator sugar (parity: layers/math_op_patch.py)
    def _elementwise(self, other, op_type, reverse=False):
        from ..layers import elementwise_op_with_scalar

        return elementwise_op_with_scalar(self, other, op_type, reverse)

    def __add__(self, other):
        return self._elementwise(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._elementwise(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._elementwise(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._elementwise(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._elementwise(other, "elementwise_div")

    def __matmul__(self, other):
        from ..layers import matmul

        return matmul(self, other)

    def __neg__(self):
        from ..layers import scale

        return scale(self, scale=-1.0)

    def __repr__(self):
        kind = "Parameter" if self.is_parameter else "Variable"
        return f"{kind}(name={self.name}, shape={self.shape}, dtype={self.dtype})"

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "is_parameter": self.is_parameter,
            "lod_level": self.lod_level,
        }


class Parameter(Variable):
    """Trainable persistable variable. Parity: framework.py:4631."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 trainable=True, regularizer=None, **kwargs):
        super().__init__(
            block, name=name, shape=shape, dtype=dtype,
            persistable=True, stop_gradient=not trainable,
        )
        self.trainable = trainable
        self.regularizer = regularizer
        self.initializer = kwargs.get("initializer")


class Operator:
    """One recorded op. Parity: framework.py:1706 / OpDesc (framework.proto:42).

    inputs/outputs map slot name -> list of variable names (strings), like
    OpDesc.Var in the proto.
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {}
        self.outputs = {}
        self.attrs = dict(attrs or {})
        for slot, vs in (inputs or {}).items():
            self.inputs[slot] = [v.name if isinstance(v, Variable) else v
                                 for v in _as_list(vs)]
        for slot, vs in (outputs or {}).items():
            self.outputs[slot] = [v.name if isinstance(v, Variable) else v
                                  for v in _as_list(vs)]
        # creation site for error decoration (op_call_stack.cc parity):
        # first caller frame outside paddle_tpu_torch
        self.callsite = _user_callsite()
        # provenance for graph-optimizer rewrites: scope names of the
        # source ops this op absorbed (the fusion tier, passes/fuse.py,
        # sets it), so per-op attribution of an optimized program maps
        # fused ops back to what the user built
        self.folded_from = ()

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"

    def to_dict(self):
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": _jsonable_attrs(self.attrs),
        }


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if k.startswith("_") and k != "_amp_inserted":
            # underscore attrs are runtime-only (rng keys etc.) —
            # except the AMP pin tag, a plain bool the numerics
            # analyzer must still see on a reloaded program (an
            # untagged identity pin would lint as PT403 churn)
            continue
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, Block):
            out[k] = {"__block__": v.idx}
        else:
            out[k] = v
    return out


class Block:
    """Op list + var scope. Parity: framework.py:2176 / BlockDesc."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}  # name -> Variable
        self.ops = []

    # -- vars ---------------------------------------------------------------

    def create_var(self, name=None, **kwargs):
        var = Variable(self, name=name, **kwargs)
        self.vars[var.name] = var
        self.program._bump()
        return var

    def create_parameter(self, name=None, shape=None, dtype="float32",
                         trainable=True, regularizer=None, initializer=None):
        p = Parameter(self, name=name, shape=shape, dtype=dtype,
                      trainable=trainable, regularizer=regularizer,
                      initializer=initializer)
        # creation provenance, like ops: the sharding lints (PT301/302)
        # blame a parameter, not an op — the callsite names where the
        # layer that made it was called
        p.callsite = _user_callsite()
        self.vars[p.name] = p
        self.program._bump()
        return p

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(
                f"variable '{name}' not found in block {self.idx}"
                + self._did_you_mean(name))
        return v

    def _did_you_mean(self, name):
        """Close-match suggestions over this block + its ancestors —
        a typo'd fetch/feed name gets candidates instead of a bare
        name error (op_call_stack-style ergonomics for the graph
        API).  Shares the module-level did_you_mean rule with the
        sharding rule engine's zero-match reporting."""
        candidates = set()
        b = self
        while True:
            candidates.update(b.vars)
            if b.parent_idx < 0:
                break
            b = self.program.blocks[b.parent_idx]
        return did_you_mean(name, candidates)

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        b = self
        while True:
            if name in b.vars:
                return b.vars[name]
            if b.parent_idx < 0:
                return None
            b = self.program.blocks[b.parent_idx]

    def all_parameters(self):
        return [v for v in self.vars.values() if v.is_parameter]

    # -- ops ----------------------------------------------------------------

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump()
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": {n: v.to_dict() for n, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }


class BackwardSection:
    """Marker recorded by append_backward: 'at op position `pos`, compute
    grads of `loss` w.r.t. `params` into <name>@GRAD vars'.  The port's
    executor realizes it with torch.autograd.grad over the preceding op
    segment — the counterpart of the grad-op chain appended by Paddle-Fluid's
    fluid/backward.py:1145."""

    def __init__(self, pos, loss_name, param_names, no_grad_set=None,
                 checkpoint_names=None):
        self.pos = pos
        self.loss_name = loss_name
        self.param_names = list(param_names)
        self.no_grad_set = set(no_grad_set or ())
        # recompute segments (RecomputeOptimizer parity): activation names
        # marked as checkpoints; the executor recomputes the chunks up to
        # each in the backward.
        self.checkpoint_names = list(checkpoint_names or ())


class Program:
    """Parity: framework.py:3602 / ProgramDesc (framework.proto:211)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = None
        self._version = 0
        self.backward_sections = []
        self._is_test = False
        # amp state set by amp.decorate; consulted by the executor
        self.amp_enabled = False
        # executor run-plan (executor._RunPlan): the steady-state
        # dispatch analysis cached per (program, _version).  Lives on
        # the Program — not in an id()-keyed executor dict — so a
        # recycled address after GC can never serve a stale plan.
        self._run_plan_cache = None
        # graph-optimizer state: optimize-time-evaluated constants
        # ({name: ndarray} — the executor seeds scopes from it) and the
        # cache of optimized substitute programs keyed by
        # (version, fetches, pass config)
        self._folded_constants = None
        self._opt_cache = None

    # -- structure ----------------------------------------------------------

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None):
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        return b

    def rollback(self):
        self.current_block_idx = self.blocks[self.current_block_idx].parent_idx

    def _bump(self):
        # every graph mutation lands here.  The version bump re-keys
        # the compiled-step cache; the derived caches living ON the
        # program (run-plan, lint results, optimized substitutes) are
        # dropped in the same call so no consumer can observe a window
        # where the version moved but a stale artifact still answers.
        self._version += 1
        self._run_plan_cache = None
        cache = getattr(self, "_lint_cache", None)
        if cache:
            cache.clear()
        self._opt_cache = None

    def all_parameters(self):
        return [p for b in self.blocks for p in b.all_parameters()]

    def list_vars(self):
        return [v for b in self.blocks for v in b.vars.values()]

    def num_ops(self):
        return sum(len(b.ops) for b in self.blocks)

    # -- clone / prune ------------------------------------------------------

    def clone(self, for_test=False):
        """Deep-copy the program. for_test=True marks test mode: executor
        runs batch_norm/dropout in inference mode and skips backward
        sections (parity: Program.clone framework.py:3806)."""
        p = Program()
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                cls = Parameter if v.is_parameter else Variable
                nv = cls.__new__(cls)
                nv.__dict__.update({k: copy.copy(val) for k, val in v.__dict__.items()
                                    if k != "block"})
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                no = Operator(nb, op.type)
                no.inputs = {k: list(v) for k, v in op.inputs.items()}
                no.outputs = {k: list(v) for k, v in op.outputs.items()}
                no.attrs = dict(op.attrs)
                no.folded_from = getattr(op, "folded_from", ())
                if for_test and "is_test" in _TEST_MODE_OPS.get(op.type, ()):
                    no.attrs["is_test"] = True
                nb.ops.append(no)
            p.blocks.append(nb)
        p.current_block_idx = 0
        p.random_seed = self.random_seed
        p._is_test = for_test
        p.amp_enabled = self.amp_enabled
        if self._folded_constants:
            p._folded_constants = dict(self._folded_constants)
        # sharding-rule attachment (analysis metadata) rides along:
        # the for_test eval twin must lint PT3xx like its parent
        rules = getattr(self, "_sharding_rules", None)
        if rules is not None:
            p._sharding_rules = rules
        if for_test:
            # prune backward + optimize ops (parity: Program.clone's test
            # mode, framework.py:3806 — everything appended after the first
            # backward marker is training-only)
            if self.backward_sections:
                cutoff = min(s.pos for s in self.backward_sections)
                p.global_block().ops = p.global_block().ops[:cutoff]
        else:
            p.backward_sections = [copy.deepcopy(s) for s in self.backward_sections]
        return p

    def _prune(self, fetch_names):
        """Keep only ops needed to produce fetch_names (parity:
        Program._prune, used by save_inference_model)."""
        needed = set(fetch_names)
        keep_idx = set()
        ops = self.global_block().ops
        for i in range(len(ops) - 1, -1, -1):
            if set(ops[i].output_names()) & needed:
                keep_idx.add(i)
                needed |= set(ops[i].input_names())
        pruned = self.clone(for_test=True)
        pruned.global_block().ops = [
            op for i, op in enumerate(pruned.global_block().ops) if i in keep_idx
        ]
        return pruned

    # -- serialization ------------------------------------------------------

    def to_json(self):
        doc = {
            "version": 1,
            "blocks": [b.to_dict() for b in self.blocks],
            "backward_sections": [
                {"pos": s.pos, "loss": s.loss_name, "params": s.param_names,
                 "checkpoints": s.checkpoint_names}
                for s in self.backward_sections
            ],
            "is_test": self._is_test,
            # an AMP-rewritten program must round-trip as rewritten:
            # a reloaded substitute fed back through rewrite_train_
            # program (e.g. tools/program_lint.py --amp) would
            # otherwise be double-cast
            "amp_enabled": self.amp_enabled,
        }
        if self._folded_constants:
            doc["folded_constants"] = {
                n: {"__ndarray__": np.asarray(v).tolist(),
                    "dtype": str(np.asarray(v).dtype)}
                for n, v in self._folded_constants.items()
            }
        return json.dumps(doc)

    @staticmethod
    def from_json(text):
        data = json.loads(text)
        p = Program()
        p.blocks = []
        for bd in data["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for name, vd in bd["vars"].items():
                cls = Parameter if vd.get("is_parameter") else Variable
                if cls is Parameter:
                    v = Parameter(b, name=name, shape=vd["shape"], dtype=vd["dtype"],
                                  trainable=not vd["stop_gradient"])
                else:
                    v = Variable(b, name=name, shape=vd["shape"], dtype=vd["dtype"],
                                 persistable=vd["persistable"],
                                 stop_gradient=vd["stop_gradient"],
                                 is_data=vd.get("is_data", False))
                b.vars[name] = v
            for od in bd["ops"]:
                op = Operator(b, od["type"])
                op.inputs = od["inputs"]
                op.outputs = od["outputs"]
                op.attrs = _attrs_from_json(od["attrs"])
                b.ops.append(op)
            p.blocks.append(b)
        for sd in data.get("backward_sections", []):
            p.backward_sections.append(
                BackwardSection(sd["pos"], sd["loss"], sd["params"],
                                checkpoint_names=sd.get("checkpoints")))
        p._is_test = data.get("is_test", False)
        p.amp_enabled = data.get(
            "amp_enabled",
            # pre-amp_enabled serializations: the AMP rewrite's tagged
            # cast pins are the durable evidence it already ran
            any(op.get("attrs", {}).get("_amp_inserted")
                for bd in data["blocks"] for op in bd["ops"]))
        fc = data.get("folded_constants")
        if fc:
            p._folded_constants = {
                n: np.array(v["__ndarray__"], dtype=v["dtype"])
                for n, v in fc.items()
            }
        return p

    def to_string(self, throw_on_error=False):
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx} (parent {b.parent_idx}):")
            for v in b.vars.values():
                lines.append(f"  {v!r}")
            for op in b.ops:
                lines.append(f"  {op!r}")
        return "\n".join(lines)

    __str__ = to_string


def _attrs_from_json(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


# ops whose behavior flips in test mode (clone(for_test=True))
_TEST_MODE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
}


# ---------------------------------------------------------------------------
# Default programs + guards (parity: framework.py:4879 default_main_program)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _main_program, _startup_program
    old_main, old_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program = old_main
        _startup_program = old_startup


def data(name, shape, dtype="float32", lod_level=0):
    """Declare a feed variable (parity: fluid.data)."""
    block = default_main_program().global_block()
    return block.create_var(
        name=name, shape=shape, dtype=dtype, is_data=True,
        stop_gradient=True, lod_level=lod_level,
    )


@contextlib.contextmanager
def name_scope(prefix):
    """Cosmetic op namespace (parity: fluid.name_scope)."""
    with unique_name.guard(unique_name.generator):
        yield
