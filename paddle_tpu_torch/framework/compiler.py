"""CompiledProgram — data-parallel execution of a static-graph Program
(port of paddle_tpu/framework/compiler.py).

Paddle-Fluid's CompiledProgram (fluid/compiler.py:87, :296
_compile_data_parallel -> core.ParallelExecutor) clones the graph per
device and inserts allreduce op-handles.  The JAX package lowers the same
Program to one SPMD step over a "dp" mesh axis.  The port runs the
Program's ops once per dp rank (`Executor.run`, framework/executor.py):
state replicated, each feed split over the ranks on its leading dim, the
gradients all-reduced between each BackwardSection and the update ops
(`transpiler.collective.sync_gradients`, bucketed), the state that ranks
change differently (batch-norm running stats) averaged after the step.

The ranks (`places` of `with_data_parallel`):
- None: every rank of the initialised `torch.distributed` process group,
  one process a rank, each process feeding its own shard; with no group,
  one rank on the executor's device;
- an int W, or a list of W places: W ranks held in this process
  (`distributed.inprocess.local_meshes(dp=W)`, a thread a rank) on the
  listed devices or on the executor's device, each given 1/W of the feed.

Fetch semantics mirror ParallelExecutor: a fetched tensor of rank >= 1
comes back concatenated over the dp ranks, a rank-0 one averaged, so a
[1]-shaped loss fetched over W ranks comes back as shape [W].

`with_sharding_rules(rules)` attaches partition rules for the static
analyzer; with `execute=True` the Executor runs the lowered plan on the
rule mesh (`framework/spmd.py`), its dp axis as above.
"""

import contextlib

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "resolve_precision", "apply_precision_policy"]

_PRECISIONS = ("bfloat16", "tensorfloat32", "float32", "highest")


# ---------------------------------------------------------------------------
# Precision policy — the explicit matmul precision of compiled steps
# ---------------------------------------------------------------------------

def resolve_precision(program=None):
    """Precision for a compiled step: the program's own override
    (CompiledProgram.with_precision) wins, else
    FLAGS_conv_matmul_precision, else None (torch's settings as they
    are).  Values: "tensorfloat32" (TF32 products), "float32" / "highest"
    (full-precision products); "bfloat16" is ROADMAP item 10."""
    p = getattr(program, "_precision", None) if program is not None else None
    if p is None:
        from .. import flags

        p = flags.flag("conv_matmul_precision") or None
    return p


@contextlib.contextmanager
def _precision_scope(precision):
    import torch

    tf32 = precision == "tensorfloat32"
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def apply_precision_policy(fn, precision):
    """Wrap a step callable so that its matmuls and convolutions run at
    `precision` ("float32"/"highest": TF32 off for matmuls and cuDNN;
    "tensorfloat32": on), the settings restored after each call.  No-op
    for a falsy precision."""
    if not precision:
        return fn
    if precision == "bfloat16":
        raise NotImplementedError(
            "precision 'bfloat16' (a bf16 matmul-precision policy for the "
            "whole step, not AMP) is not ported to paddle_tpu_torch yet "
            "(ROADMAP item 10); FLAGS_amp runs the white-list ops in bf16")
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; use one of "
                         f"{_PRECISIONS}")
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _precision_scope(precision):
            return fn(*args, **kwargs)

    return wrapped


class BuildStrategy:
    """Parity shim for details/build_strategy.h:37; the graph-surgery
    options (fuse passes, memory optimize) are accepted and ignored, as in
    the reference."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = 0
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_reduce_ops = None
        self.fuse_elewise_add_act_ops = None
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """Parity shim for ExecutionStrategy: thread counts mean nothing to
    the port's Executor; kept for script parity."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1


class CompiledProgram:
    """Wrap a Program for (optionally data-parallel) execution.

        compiled = CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        exe.run(compiled, feed=..., fetch_list=[loss])

    Without with_data_parallel, running a CompiledProgram is running the
    raw Program.
    """

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = None
        self._is_data_parallel = False
        self._dp_places = None
        self._loss_name = None
        self._precision = None
        self._telemetry_label = None
        self._dp_mesh_cache = None   # (key, mode, meshes) — see _dp_meshes
        self._is_spmd = False
        self._spmd_rules = None
        self._spmd_places = None
        self._spmd_mesh_cache = None  # (key, mode, meshes) — _spmd_meshes

    def with_precision(self, precision):
        """Pin the matmul/conv precision this program runs with
        ("tensorfloat32" | "float32" | "highest"; "bfloat16" is ROADMAP
        item 10); overrides FLAGS_conv_matmul_precision for this program
        only."""
        self._precision = precision
        return self

    def with_telemetry(self, label):
        """Name this program in the telemetry ledger (the port keeps the
        label; the monitor that reads it is ROADMAP item 10)."""
        self._telemetry_label = label
        return self

    def with_sharding_rules(self, rules, mesh=None, data_axis="dp",
                            execute=False, places=None):
        """Attach a partition-rule set for the static sharding analyzer:
        under ``FLAGS_static_check`` the verifier lints the program
        against these rules (PT301-PT306) before any op runs.

        ``rules`` is an ``analysis.sharding.PartitionRules``, a
        ``{"mesh": ..., "rules": ...}`` dict (the rule-file format), or
        a plain ``[(regex, dims), ...]`` list with ``mesh`` given
        separately.  Attachment is analysis metadata, not a graph
        mutation: the program version does not bump, and the lint
        cache keys on the rule fingerprint.

        ``execute=True`` is the GSPMD runtime tier
        (`framework/spmd.py`): the executor lowers these rules
        (`analysis.sharding.lower`) and runs the plan, each rank of the
        rule mesh holding only its shards.  ``places`` pins the rule
        mesh's devices, one a rank in rank order (ranks held in this
        process, as ``with_data_parallel(places=[...])``); without it
        the ranks are the processes of the initialised process group
        when its size is the mesh's, else ranks held in this process on
        the executor's device.  Re-attaching a different rule set
        re-lowers (the plan and state caches key on the rule
        fingerprint and the mesh's device identity)."""
        from ..analysis import sharding as _sh

        if isinstance(rules, dict):
            rules = _sh.PartitionRules.from_dict(rules)
        elif not isinstance(rules, _sh.PartitionRules):
            if mesh is None:
                raise ValueError(
                    "with_sharding_rules(list_of_rules) needs mesh=")
            rules = _sh.PartitionRules(rules, mesh,
                                       data_axis=data_axis)
        _sh.attach(self._program, rules)
        if execute:
            self._is_spmd = True
            self._spmd_rules = rules
            if places is not None:
                self._spmd_places = places
            self._spmd_mesh_cache = None
        return self

    # -- the GSPMD runtime tier -------------------------------------------
    def _spmd_meshes(self, device=None):
        """("process", [mesh]) when the ranks are the processes of the
        initialised process group (its size is the rule mesh's), else
        ("threads", meshes): the rule mesh's ranks held in this process
        (`inprocess.local_meshes(axes=...)`) on the `places` devices or
        on `device` (None: the card).  Memoized per (rule fingerprint,
        device, world)."""
        import math

        import torch.distributed as dist

        from ..distributed import inprocess
        from ..distributed.mesh import build_rule_mesh

        rules = self._spmd_rules
        if rules is None:
            raise ValueError(
                "no executable rules: with_sharding_rules(..., "
                "execute=True) first")
        axes = rules.mesh.to_dict() or {"dp": 1}
        places = self._spmd_places
        need = math.prod(axes.values())
        group = places is None and dist.is_available() \
            and dist.is_initialized() and dist.get_world_size() == need
        key = (rules.fingerprint(), str(device),
               dist.get_world_size() if group else None)
        cached = self._spmd_mesh_cache
        if cached is not None and cached[0] == key:
            return cached[1], cached[2]
        if group:
            mode, meshes = "process", [build_rule_mesh(axes)]
        else:
            devices = None
            if isinstance(places, (list, tuple)) and places:
                devices = list(places)
            mode = "threads"
            meshes = inprocess.local_meshes(axes=axes, device=device,
                                            devices=devices)
        self._spmd_mesh_cache = (key, mode, meshes)
        return mode, meshes

    def _spmd_mesh(self, device=None):
        """The rule mesh: this process's `Mesh` over a process group, or
        the list of the ranks held in this process."""
        mode, meshes = self._spmd_meshes(device)
        return meshes[0] if mode == "process" else meshes

    def _spmd_layout(self, device=None):
        """Shared MeshLayout of the rule mesh, keyed on (mesh, rule
        fingerprint) in the distributed.mesh cache."""
        from ..distributed.mesh import mesh_layout

        rules = self._spmd_rules
        return mesh_layout(self._spmd_mesh(device),
                           data_axis=rules.data_axis,
                           fingerprint=rules.fingerprint())

    def _spmd_key(self, device=None):
        """Cache key of the spmd tier: the mesh's device identity and the
        rule fingerprint — re-attaching rules or retargeting the mesh
        re-lowers instead of serving a stale layout."""
        layout = self._spmd_layout(device)
        return (layout.key, layout.fingerprint)

    # -- reference API ---------------------------------------------------
    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """compiler.py:296 parity; `places` as in the module docstring."""
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy
        self._dp_places = places
        self._dp_mesh_cache = None
        return self

    def retarget_dp(self, places):
        """Re-point the dp ranks at a new place set mid-run (the
        reference's elastic hook): same contract as the places= of
        with_data_parallel."""
        if not self._is_data_parallel:
            raise ValueError("retarget_dp needs with_data_parallel first")
        self._dp_places = places
        self._dp_mesh_cache = None
        return self

    # -- executor integration -------------------------------------------
    def _get_executable_program(self):
        return self._program

    def _dp_meshes(self, device):
        """("process", [mesh]) when the ranks are the processes of the
        initialised process group, else ("threads", meshes): W meshes of
        ranks held in this process.  Memoized per (device, world) until
        with_data_parallel or retarget_dp re-targets the places."""
        import torch.distributed as dist

        from ..core.place import resolve_device
        from ..distributed import inprocess
        from ..distributed.mesh import build_mesh

        places = self._dp_places
        group = places is None and dist.is_available() \
            and dist.is_initialized()
        key = (device, dist.get_world_size() if group else None)
        cached = self._dp_mesh_cache
        if cached is not None and cached[0] == key:
            return cached[1], cached[2]
        if group:
            mode, meshes = "process", [build_mesh(
                dp=dist.get_world_size())]
        else:
            if places is None:
                devices = [device]
            elif isinstance(places, int):
                if places < 1:
                    raise ValueError(f"places={places}: need at least one "
                                     f"rank")
                devices = [device] * places
            else:
                devices = [resolve_device(p) for p in places]
                if not devices:
                    raise ValueError("places=[]: need at least one rank")
            meshes = inprocess.local_meshes(dp=len(devices),
                                            device=devices[0])
            for m, d in zip(meshes, devices):
                m.device = d
            mode = "threads"
        self._dp_mesh_cache = (key, mode, meshes)
        return mode, meshes
