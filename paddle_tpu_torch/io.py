"""Model IO: save/load variables and inference models (port of
paddle_tpu/io.py).

The same files as the JAX package: the persistable state of a Scope as
one `.npz` (`__params__.npz` by default) and an inference model as the
pruned Program's JSON (`__model__.json`: the Program, the feed names and
the fetch names) beside its persistables.  A directory saved by either
package loads in the other.  bfloat16 values are written as the JAX
package writes them (raw 2-byte words under numpy's '<V2' descr, see
`interop.save_npz`) and read back as bfloat16, so the two packages'
files hold the same bytes.

`load_vars` puts each tensor on `executor.device` (the card unless the
executor was made for the CPU), in the device dtype of the stored array
(64-bit narrowed, as the Executor's feeds).
"""

import json
import os

import numpy as np

from .core.dtype import to_torch_dtype
from .core.place import resolve_device
from .framework.executor import global_scope
from .framework.program import Program, default_main_program
from .interop import from_numpy_exact, save_npz, to_numpy_exact


def _device(executor):
    dev = getattr(executor, "device", None)
    return dev if dev is not None else resolve_device(None)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    program = main_program or default_main_program()
    scope = global_scope()
    if vars is not None:
        names = [v.name if hasattr(v, "name") else v for v in vars]
    else:
        candidates = program.list_vars()
        if predicate is not None:
            candidates = [v for v in candidates if predicate(v)]
        names = [v.name for v in candidates]
    os.makedirs(dirname, exist_ok=True)
    payload = {}
    for n in names:
        val = scope.find_var(n)
        if val is None:
            continue
        payload[n] = to_numpy_exact(val)
    path = os.path.join(dirname, filename or "__params__.npz")
    save_npz(path, payload)
    return path


def save_params(executor, dirname, main_program=None, filename=None):
    program = main_program or default_main_program()
    return save_vars(executor, dirname, program,
                     predicate=lambda v: v.is_parameter, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    program = main_program or default_main_program()
    return save_vars(executor, dirname, program,
                     predicate=lambda v: v.persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    path = os.path.join(dirname, filename or "__params__.npz")
    scope = global_scope()
    program = main_program or default_main_program()
    if vars is not None:
        wanted = {v.name if hasattr(v, "name") else v for v in vars}
    else:
        candidates = program.list_vars()
        if predicate is not None:
            candidates = [v for v in candidates if predicate(v)]
        wanted = {v.name for v in candidates}
    dev = _device(executor)
    with np.load(path) as data:
        for n in data.files:
            if n in wanted:
                t = from_numpy_exact(data[n])
                scope.set_var(n, t.to(device=dev,
                                      dtype=to_torch_dtype(t.dtype)))


def load_params(executor, dirname, main_program=None, filename=None):
    program = main_program or default_main_program()
    load_vars(executor, dirname, program,
              predicate=lambda v: v.is_parameter, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    program = main_program or default_main_program()
    load_vars(executor, dirname, program,
              predicate=lambda v: v.persistable, filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """Prune the program to the inference subgraph and save it with its
    persistables (parity: the reference's io.py:1022)."""
    program = main_program or default_main_program()
    target_names = [v.name if hasattr(v, "name") else v for v in target_vars]
    pruned = program._prune(target_names)
    os.makedirs(dirname, exist_ok=True)
    model = {
        "program": json.loads(pruned.to_json()),
        "feed_names": list(feeded_var_names),
        "fetch_names": target_names,
    }
    with open(os.path.join(dirname, model_filename or "__model__.json"),
              "w") as f:
        json.dump(model, f)
    save_persistables(executor, dirname, pruned, filename=params_filename)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    with open(os.path.join(dirname, model_filename or "__model__.json")) as f:
        model = json.load(f)
    program = Program.from_json(json.dumps(model["program"]))
    load_persistables(executor, dirname, program, filename=params_filename)
    return program, model["feed_names"], model["fetch_names"]
