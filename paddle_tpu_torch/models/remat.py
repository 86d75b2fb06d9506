"""Selective recompute for `make_train_step(remat="conv_outs")`: keep the
conv outputs, recompute the elementwise tail in the backward.

The reference names each conv output (`checkpoint_name(out, "conv_out")`
in its conv ops) and wraps the loss in `jax.checkpoint` with
`save_only_these_names("conv_out")`; XLA then recomputes each
remaining residual where the backward needs it.  torch's selective
checkpoint (`create_selective_checkpoint_contexts` under non-reentrant
`torch.utils.checkpoint`) keeps the right tensors but recomputes its
whole region at the first unpack, so the backward would again hold
every residual at once.  `ConvOutsTape` recomputes locally instead:

- a `TorchDispatchMode` records, below autograd, every aten op of the
  forward with its arguments (tensors as references to the op that made
  them, or to the tensor itself when it is kept);
- `saved_tensors_hooks` store each tensor autograd saves either as
  itself (kept) or as a handle to the op that made it;
- in the backward an unpacked handle replays that op's ancestors back to
  the nearest kept tensors, each op once, holding a replayed value only
  while a later unpack or replay still needs it.

Kept, as the policy's MUST_SAVE: the outputs of the convolution ops
(`aten.convolution` and its backends; the dispatch mode sees
`aten.convolution.default` on the CPU and on the card), of random ops
(dropout masks), of ops that write into their arguments, of
uninitialized allocations (`empty*`: a hand-written kernel's output,
filled by a launch the mode cannot see) and of every op run with grad
off, which covers the forward of a custom autograd Function: the fused
K7/K8/K9 blocks and the K1/K4 Functions keep what they save, where the
reference recomputes its Pallas blocks whole.  Everything else is
recomputed, PREFER_RECOMPUTE.  The replay runs the same ops on the same
inputs, so the gradients equal `remat=False`'s bit for bit on the CPU.

Tensors are matched by storage and view (the storage's C++ address,
offset, sizes, strides, dtype) behind a weak reference to the storage,
so a view that autograd re-wraps still finds its producer and a freed
address never aliases a live tensor.

Every tensor the backward reads as itself (kept, a parameter, an input)
is held with its version counter, and reading it after an in-place op
changed it raises, as autograd does for its saved tensors (which the
hooks take out of autograd's own check).
"""

import collections
import contextlib

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

_CONV_OPS = frozenset((
    "aten::convolution", "aten::_convolution", "aten::cudnn_convolution",
    "aten::mkldnn_convolution", "aten::convolution_overrideable",
    "aten::miopen_convolution", "aten::_slow_conv2d_forward",
    "aten::slow_conv_dilated2d", "aten::_nnpack_spatial_convolution",
    "aten::cudnn_convolution_transpose", "aten::slow_conv_transpose2d"))
_UNINIT_OPS = frozenset((
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided"))


def is_conv(func):
    return func._schema.name in _CONV_OPS


def _keeps(func):
    """True where the op's outputs are kept rather than recomputed."""
    name = func._schema.name
    return (name in _CONV_OPS or name in _UNINIT_OPS
            or torch.Tag.nondeterministic_seeded in func.tags
            or func._schema.is_mutable or not torch.is_grad_enabled())


def _key(t):
    st = t.untyped_storage()
    return (st._cdata, t.storage_offset(), tuple(t.shape), tuple(t.stride()),
            t.dtype, t.device)


def _unchanged(t, version):
    """`t`, unless an in-place op changed it after the forward read it."""
    if t._version != version:
        raise RuntimeError(
            f"remat='conv_outs': a tensor the backward needs (shape "
            f"{tuple(t.shape)}, {t.dtype}) was modified by an inplace "
            f"operation after the forward read it (version {t._version}, "
            f"expected {version})")
    return t


class _Entry:
    __slots__ = ("func", "spec", "args")

    def __init__(self, func, spec, args):
        self.func, self.spec, self.args = func, spec, args


class _Handle:
    """What autograd holds for a recomputed tensor."""

    __slots__ = ("idx", "pos")

    def __init__(self, idx, pos):
        self.idx, self.pos = idx, pos


class ConvOutsTape(TorchDispatchMode):
    """`with tape.recording(): loss = f(...)`, then the backward as usual
    (see the module docstring).  `stats()` counts what the forward
    stored."""

    def __init__(self):
        super().__init__()
        self._entries = []
        # storage-and-view key -> (storage weak ref, kept or (idx, pos))
        self._producer = {}
        self._values = {}       # (idx, pos) -> replayed tensor
        self._pending = collections.Counter()   # (idx, pos) -> uses left
        self._done = set()      # entries replayed
        # what the forward stored, for `stats`: storage address -> bytes
        self._kept = {}
        self._convs = set()
        self.handle_packs = 0

    # -- forward ---------------------------------------------------------

    def _lookup(self, t):
        hit = self._producer.get(_key(t))
        if hit is None or hit[0].expired():
            return None
        return hit[1]

    def _ref(self, a):
        if not isinstance(a, torch.Tensor):
            return a
        p = self._lookup(a)
        return (("t", a, a._version) if p is None or p == "keep"
                else ("e",) + p)

    def _mark(self, t, value):
        key = _key(t)
        if value != "keep":
            # a view identical to a kept tensor (an alias, a detach) is
            # that tensor
            old = self._producer.get(key)
            if old is not None and old[1] == "keep" and not old[0].expired():
                return
        self._producer[key] = (StorageWeakRef(t.untyped_storage()), value)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat_out, _ = tree_flatten(out)
        if _keeps(func):
            for t in flat_out:
                if isinstance(t, torch.Tensor):
                    self._mark(t, "keep")
                    if is_conv(func):
                        self._convs.add(t.untyped_storage()._cdata)
            if func._schema.is_mutable:
                for a, arg in zip(args, func._schema.arguments):
                    if (isinstance(a, torch.Tensor)
                            and arg.alias_info is not None
                            and arg.alias_info.is_write):
                        self._mark(a, "keep")
            return out
        flat_in, spec = tree_flatten((args, kwargs))
        idx = len(self._entries)
        self._entries.append(_Entry(func, spec,
                                    [self._ref(a) for a in flat_in]))
        for pos, t in enumerate(flat_out):
            if isinstance(t, torch.Tensor):
                self._mark(t, (idx, pos))
        return out

    def _pack(self, t):
        p = self._lookup(t)
        if p is None or p == "keep":
            st = t.untyped_storage()
            self._kept[st._cdata] = st.nbytes()
            return (t, t._version)
        self._pending[p] += 1
        self.handle_packs += 1
        return _Handle(*p)

    @contextlib.contextmanager
    def recording(self):
        """The context of the forward: this mode and the saved-tensor
        hooks."""
        with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                      self._unpack):
            with self:
                yield self
        self._count_uses()

    def _count_uses(self):
        """How often each entry's outputs are read by the replay: once per
        handle autograd holds and once per input edge of an entry the
        replay will run (live: reachable from a handle)."""
        live = [False] * len(self._entries)
        stack = [idx for idx, _ in self._pending]
        while stack:
            i = stack.pop()
            if live[i]:
                continue
            live[i] = True
            for a in self._entries[i].args:
                if isinstance(a, tuple) and a and a[0] == "e":
                    stack.append(a[1])
        for i, e in enumerate(self._entries):
            if not live[i]:
                self._entries[i] = None
                continue
            for a in e.args:
                if isinstance(a, tuple) and a and a[0] == "e":
                    self._pending[(a[1], a[2])] += 1
                elif isinstance(a, tuple) and a and a[0] == "t":
                    # a kept tensor the replay reads: held as autograd's
                    st = a[1].untyped_storage()
                    self._kept[st._cdata] = st.nbytes()

    # -- backward --------------------------------------------------------

    def _unpack(self, h):
        if isinstance(h, tuple):
            return _unchanged(*h)
        return self._get((h.idx, h.pos))

    def _release(self, key):
        self._pending[key] -= 1
        if self._pending[key] <= 0:
            self._values.pop(key, None)

    def _get(self, key):
        """The value of entry output `key`, replaying its ancestors (each
        once, iteratively) where they are not held."""
        with torch.no_grad():
            stack = [key[0]]
            while stack:
                i = stack[-1]
                if i in self._done:
                    stack.pop()
                    continue
                e = self._entries[i]
                missing = [a[1] for a in e.args
                           if isinstance(a, tuple) and a and a[0] == "e"
                           and a[1] not in self._done]
                if missing:
                    stack.extend(missing)
                    continue
                stack.pop()
                self._done.add(i)
                args = []
                for a in e.args:
                    if isinstance(a, tuple) and a and a[0] == "t":
                        args.append(_unchanged(a[1], a[2]))
                    elif isinstance(a, tuple) and a and a[0] == "e":
                        args.append(self._values[(a[1], a[2])])
                    else:
                        args.append(a)
                fargs, fkwargs = tree_unflatten(args, e.spec)
                out = e.func(*fargs, **fkwargs)
                for a in e.args:
                    if isinstance(a, tuple) and a and a[0] == "e":
                        self._release((a[1], a[2]))
                flat_out, _ = tree_flatten(out)
                for pos, t in enumerate(flat_out):
                    if self._pending[(i, pos)] > 0:
                        self._values[(i, pos)] = t
            value = self._values[key]
        self._release(key)
        return value

    def stats(self):
        """What the forward stored: the distinct storages held (saved by
        autograd as themselves, or read by the replay) and their bytes,
        the handles, the conv outputs seen and how many of them are among
        the held storages."""
        return {"kept_storages": len(self._kept),
                "kept_bytes": sum(self._kept.values()),
                "handles": self.handle_packs,
                "conv_outputs": len(self._convs),
                "conv_outputs_kept": len(self._convs & set(self._kept))}
