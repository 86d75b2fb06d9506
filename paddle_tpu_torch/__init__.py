"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

Module paths and names mirror the JAX package (`paddle_tpu/`), so the
counterpart of `paddle_tpu/models/generate.py` is
`paddle_tpu_torch/models/generate.py`.  The port imports `torch` and
never `jax`, and nothing of `paddle_tpu`.

The top-level namespace carries the Paddle-Fluid static-graph surface the
port has so far, so that a fluid script runs unchanged:

    import paddle_tpu_torch as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 13])
        loss = fluid.layers.mean(fluid.layers.fc(x, 1))
        fluid.optimizer.SGD(0.01).minimize(loss)
    exe = fluid.Executor()          # cuda; fluid.CPUPlace() for the host
    exe.run(startup)
    exe.run(main, feed={"x": ...}, fetch_list=[loss])

Entry points run on `cuda` unless the caller passes `device="cpu"` (or a
CPUPlace); there is no silent CPU fallback when no GPU is found.  Every
Pallas kernel on a ported path is a kernel written by hand for Hopper
(`kernels/`, `csrc/`), dispatched for CUDA tensors inside the kernel's
envelope; on CPU tensors the kernel's plain PyTorch version runs.
"""

from . import core, flags  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .core.place import CPUPlace, CUDAPlace, TPUPlace  # noqa: F401
from . import framework  # noqa: F401
from .framework import (  # noqa: F401
    Executor, Parameter, Program, Scope, Variable, append_backward,
    data, default_main_program, default_startup_program, global_scope,
    gradients, name_scope, program_guard, scope_guard,
)
from .framework.param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from . import (  # noqa: F401
    backward, checkpoint, clip, data_feeder, executor, inference,
    initializer, io, layer_helper, layers, optimizer, param_attr, reader,
    regularizer, unique_name,
)
from .reader import DataFeeder, DataLoader, batch  # noqa: F401

__all__ = [
    "core", "flags", "get_flags", "set_flags", "CPUPlace", "CUDAPlace",
    "TPUPlace", "framework",
    "Program", "Variable", "Parameter", "default_main_program",
    "default_startup_program", "program_guard", "name_scope", "data",
    "Executor", "Scope", "global_scope", "scope_guard", "append_backward",
    "gradients", "ParamAttr", "WeightNormParamAttr", "backward", "clip",
    "executor", "initializer", "layer_helper", "layers", "optimizer",
    "param_attr", "regularizer", "unique_name", "io", "reader",
    "inference", "checkpoint", "data_feeder", "DataLoader", "DataFeeder",
    "batch",
]
