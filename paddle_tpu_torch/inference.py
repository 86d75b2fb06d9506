"""Inference engine: Predictor and the exported artifact (port of
paddle_tpu/inference.py).

`Predictor(dirname)` serves a model saved by `io.save_inference_model`
(by either package): the pruned Program from `__model__.json`, its
parameters from `__params__.npz` on the predictor's device, interpreted
op by op in eager PyTorch (the Executor's `interpret`) under
`torch.no_grad`, stochastic ops drawing from a `torch.Generator` seeded
0 at every call, as the reference's fixed `PRNGKey(0)`.  The reference
jits the Program into one XLA computation; the port has no counterpart,
so `run` and `run_eager` are both the eager interpreter.  The fused ops
of a `passes.fuse_program` Program reach their kernels there:
`fused_attention` K1, `fused_layer_norm` K4.  With FLAGS_inference_fold
on (the default) the Program and its parameters first go through
`passes.fold_inference` (batch-norm and scale-chain folds, constant
folding, CSE, identity elimination, DCE), once, at load time.

`export_compiled` is the AOT half: `torch.export` of the pruned Program
with its parameters as the module's buffers, for concrete feed shapes,
saved as `__compiled__.pt2`; `CompiledPredictor` loads and runs it
without the Program or the model code.  The kernels an inference Program
reaches are `torch.library` custom ops in the exported graph
(`kernels/backend.traced_kernels`), so the artifact launches them too.

`run` returns numpy arrays; a bfloat16 fetch comes back as float32 (numpy
has no bfloat16 here; the widening is exact).  Every entry point takes a
`place` (a Place, a device string or a torch.device); None means `cuda`,
and raises on a host without one.
"""

import json
import os

import numpy as np
import torch

from . import flags
from .core.dtype import to_torch_dtype
from .core.place import resolve_device
from .framework.executor import feed_tensor, interpret
from .interop import from_numpy_exact

_COMPILED_FILE = "__compiled__.pt2"
_META = "paddle_tpu_torch_meta"


def _to_numpy(t):
    """A fetch as numpy: bfloat16 widened to float32 (exact); from the card
    through page-locked host memory, which the copy engine writes about
    ten times faster than pageable memory (a [8, 512, 32768] f32 logits
    fetch: 275.7 ms pageable on an H100, PERF.md)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    if t.is_cuda:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t).numpy()
    return t.numpy()


class _ProgramModule(torch.nn.Module):
    """feeds -> fetches over one pruned Program: the parameters are the
    module's buffers (frozen), the feeds its positional inputs in
    `feed_names` order."""

    def __init__(self, ops, params, feed_names, fetch_names, device):
        super().__init__()
        self._ops = ops
        self._names = list(params)
        for i, t in enumerate(params.values()):
            self.register_buffer(f"p{i}", t)
        self._feed_names = list(feed_names)
        self._fetch_names = list(fetch_names)
        self._generator = torch.Generator(device=device)

    def forward(self, *feeds):
        env = {n: getattr(self, f"p{i}") for i, n in enumerate(self._names)}
        env.update(zip(self._feed_names, feeds))
        self._generator.manual_seed(0)
        with torch.no_grad():
            interpret(self._ops, env, self._generator)
        return tuple(env[n] for n in self._fetch_names)


class Predictor:
    """Serve a saved inference model (AnalysisPredictor analogue).

    p = Predictor(dirname)            # from save_inference_model output
    outs = p.run({"x": batch})        # list of np.ndarray, one per fetch
    """

    def __init__(self, dirname, model_filename=None, params_filename=None,
                 place=None):
        from .framework.program import Program

        self.device = resolve_device(place)
        with open(os.path.join(dirname,
                               model_filename or "__model__.json")) as f:
            model = json.load(f)
        self._program = Program.from_json(json.dumps(model["program"]))
        self._feed_names = list(model["feed_names"])
        self._fetch_names = list(model["fetch_names"])
        persist = {v.name for v in self._program.list_vars()
                   if v.persistable}
        with np.load(os.path.join(dirname, params_filename
                                  or "__params__.npz")) as data:
            params = {n: from_numpy_exact(data[n]) for n in data.files
                      if n in persist}
        # FLAGS_inference_fold: the reference's inference analysis passes,
        # applied once at load time over numpy values, so run and
        # run_eager serve the same folded program (allclose, not bitwise,
        # against the unfolded one)
        self._fold_report = None
        if flags.flag("inference_fold"):
            from . import passes as _passes

            dtypes = {n: t.dtype for n, t in params.items()}
            values = {n: _to_numpy(t) for n, t in params.items()}
            self._program, values, self._fold_report = \
                _passes.fold_inference(
                    self._program, values, fetch_names=self._fetch_names,
                    program_key="predictor:%s" % os.path.basename(
                        os.path.abspath(dirname)))
            params = {}
            for n, v in values.items():
                t = from_numpy_exact(v)
                params[n] = t.to(dtypes.get(n, t.dtype))
        self._params = {n: t.to(device=self.device,
                                dtype=to_torch_dtype(t.dtype))
                        for n, t in params.items()}
        self._module = _ProgramModule(
            list(self._program.global_block().ops), self._params,
            self._feed_names, self._fetch_names, self.device)

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def _feed_dtype(self, name):
        v = self._program.global_block()._find_var_recursive(name)
        return to_torch_dtype(v.dtype) if v is not None and v.dtype \
            else None

    def prepare_feed(self, feed):
        """Validate and move one feed dict to the predictor's device in
        the program's feed dtypes: {name: tensor}.  A tensor already on
        the device is used without a trip through the host."""
        feeds = {}
        for name in self._feed_names:
            if name not in feed:
                raise KeyError(f"missing feed '{name}'")
            feeds[name] = feed_tensor(feed[name], self._feed_dtype(name),
                                       self.device)
        return feeds

    def feed_specs(self):
        """{feed name: (feature_shape, torch dtype)}: the per-example
        trailing dims (the leading batch dim stripped; None for dynamic
        trailing dims)."""
        specs = {}
        for name in self._feed_names:
            v = self._program.global_block()._find_var_recursive(name)
            shape = tuple(v.shape) if v is not None and v.shape \
                else None
            dtype = to_torch_dtype(v.dtype) if v is not None and v.dtype \
                else torch.float32
            feat = None
            if shape:
                feat = tuple(None if d in (None, -1) else int(d)
                             for d in shape[1:])
            specs[name] = (feat, dtype)
        return specs

    def _outputs(self, feeds):
        return self._module(*(feeds[n] for n in self._feed_names))

    def run(self, feed):
        """feed: dict name -> ndarray (or tensor).  Returns
        [np.ndarray] per fetch."""
        return [_to_numpy(o) for o in self._outputs(self.prepare_feed(feed))]

    def run_eager(self, feed):
        """The same interpreter as `run` (the port has no compiled path
        to degrade from); kept for the serving runtime's degraded mode."""
        return self.run(feed)

    # -- AOT --------------------------------------------------------------

    def export_compiled(self, feed_shapes, dirname=None, platforms=None):
        """Export the program for concrete feed shapes with
        `torch.export` and save it (`torch.export.save`) as
        `__compiled__.pt2` in `dirname`.

        feed_shapes: dict name -> example ndarray OR (shape, dtype).
        platforms: None, or the one device type the artifact is for,
        which must be the predictor's (a list of several raises).
        Returns the artifact path."""
        if platforms is not None:
            plats = [platforms] if isinstance(platforms, str) \
                else list(platforms)
            if len(plats) != 1:
                raise ValueError(
                    f"export_compiled: one platform per artifact, got "
                    f"{plats} (an exported program holds its parameters "
                    f"on one device)")
            if torch.device(plats[0]).type != self.device.type:
                raise ValueError(
                    f"export_compiled: platform {plats[0]!r} is not the "
                    f"predictor's device {self.device}")
        examples = []
        for n in self._feed_names:
            spec = feed_shapes[n]
            if isinstance(spec, tuple) and len(spec) == 2 \
                    and isinstance(spec[0], (list, tuple)):
                shape, dtype = spec
                examples.append(torch.zeros(tuple(shape),
                                            dtype=to_torch_dtype(dtype),
                                            device=self.device))
            else:
                examples.append(feed_tensor(spec, self._feed_dtype(n),
                                             self.device))
        from .kernels import backend

        with backend.traced_kernels(), torch.no_grad():
            exported = torch.export.export(self._module, tuple(examples))
        meta = {"feed_names": self._feed_names,
                "fetch_names": self._fetch_names,
                "feed_dtypes": [str(e.dtype).replace("torch.", "")
                                for e in examples],
                "device": str(self.device)}
        path = os.path.join(dirname or ".", _COMPILED_FILE)
        torch.export.save(exported, path,
                          extra_files={_META: json.dumps(meta)})
        return path


class CompiledPredictor:
    """Run a saved exported artifact: no Program, no model code, no
    retracing — load and call (the deployment side of the reference's
    C++ inference engine).  The kernels' custom ops are registered by
    importing `kernels.flash_attention` and `kernels.layer_norm`."""

    def __init__(self, path):
        from .kernels import flash_attention, layer_norm  # noqa: F401

        if os.path.isdir(path):
            path = os.path.join(path, _COMPILED_FILE)
        extra = {_META: ""}
        self._exported = torch.export.load(path, extra_files=extra)
        self._meta = json.loads(extra[_META])
        self._fn = self._exported.module()
        self.device = torch.device(self._meta["device"])
        self._path = path

    @property
    def in_avals(self):
        """[(shape, torch dtype)] of the inputs, in feed order."""
        names = set(self._exported.graph_signature.user_inputs)
        return [(tuple(n.meta["val"].shape), n.meta["val"].dtype)
                for n in self._exported.graph.nodes
                if n.op == "placeholder" and n.name in names]

    def get_input_names(self):
        return list(self._meta["feed_names"])

    def get_output_names(self):
        return list(self._meta["fetch_names"])

    def run(self, feed):
        feeds = [feed_tensor(feed[n], to_torch_dtype(dt), self.device)
                 for n, dt in zip(self._meta["feed_names"],
                                  self._meta["feed_dtypes"])]
        with torch.no_grad():
            outs = self._fn(*feeds)
        return [_to_numpy(o) for o in outs]


def save_compiled_inference_model(dirname, feed_shapes, model_filename=None,
                                  params_filename=None, platforms=None,
                                  place=None):
    """Export a saved inference model directory in place: adds
    `__compiled__.pt2` beside the JSON and npz, for `CompiledPredictor`
    (call after io.save_inference_model)."""
    p = Predictor(dirname, model_filename, params_filename, place=place)
    return p.export_compiled(feed_shapes, dirname, platforms=platforms)
