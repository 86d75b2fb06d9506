"""Op registry (port of paddle_tpu/ops/registry.py).

An op is a function over torch tensors with the reference's signature:

    fn(ins: dict[slot -> Tensor | list[Tensor]], attrs: dict)
        -> dict[slot -> Tensor | list[Tensor]]

The static-graph Executor looks ops up here by their Program op type.
There are no registered grad ops: gradients come from torch autograd
through the op functions, as the reference's come from JAX tracing.
"""

_OPS = {}


class OpDef:
    __slots__ = ("name", "fn", "needs_rng", "stateful")

    def __init__(self, name, fn, needs_rng=False, stateful=False):
        self.name = name
        self.fn = fn
        # needs_rng: the op draws random bits from attrs["_generator"], a
        # torch.Generator on the executor's device (dropout, random init
        # ops); the reference passes a PRNG key as attrs["_rng"]
        self.needs_rng = needs_rng
        # stateful: an output logically overwrites an input buffer
        # (optimizer updates writing ParamOut=Param, batch_norm's running
        # stats), as in the reference
        self.stateful = stateful


def register_op(name, needs_rng=False, stateful=False):
    """Decorator registering an op function under an op type name."""

    def deco(fn):
        if name in _OPS:
            raise ValueError(f"op '{name}' already registered")
        _OPS[name] = OpDef(name, fn, needs_rng=needs_rng, stateful=stateful)
        return fn

    return deco


def get_op(name):
    try:
        return _OPS[name]
    except KeyError:
        raise NotImplementedError(
            f"op '{name}' is not ported to paddle_tpu_torch yet (ROADMAP "
            f"item 10: the op corpus)") from None


def has_op(name):
    return name in _OPS
