"""Fleet — the distributed-training facade (port of
paddle_tpu/distributed/fleet.py).

Parity: the reference's incubate/fleet — fleet.init
(base/fleet_base.py:184), fleet.distributed_optimizer (:238), the role
makers (base/role_maker.py) and DistributedStrategy
(collective/__init__.py:134).  `make_train_step` turns the strategy's
knobs into a step: DGC, LocalSGD or plain data parallelism, with
`amp` as `amp.auto_cast` and `recompute` as `torch.utils.checkpoint`
around the loss; `save_persistables` and `save_inference_model` write
through `io` on the first worker.  tp, pp and sp degrees above 1 build
the reference's mesh and the step runs over its dp axis, the other axes
replicating, as the reference's does.
"""

import torch.utils.checkpoint

from ..optimizer.functional import SGD, Momentum
from .env import ParallelEnv, init_parallel_env

__all__ = ["init", "distributed_optimizer", "DistributedStrategy",
           "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "worker_index",
           "worker_num", "is_first_worker", "get_strategy",
           "make_train_step", "save_persistables",
           "save_inference_model"]


class DistributedStrategy:
    """Parity: incubate/fleet/collective/__init__.py:134 — knobs for the
    step."""

    def __init__(self):
        self.nccl_comm_num = 1            # kept for API parity (unused)
        self.use_local_sgd = False
        self.local_sgd_steps = 1
        self.use_dgc = False
        self.dgc_sparsity = 0.999
        self.dgc_rampup_begin_step = 0
        self.recompute = False
        self.recompute_checkpoints = []
        self.amp = False
        self.amp_loss_scale = 2.0 ** 15
        # mesh degrees
        self.dp_degree = None  # default: every rank
        self.tp_degree = 1
        self.pp_degree = 1
        self.sp_degree = 1


class PaddleCloudRoleMaker:
    """Parity: role_maker.py PaddleCloudRoleMaker — ranks from env vars."""

    def __init__(self, is_collective=True):
        self._env = ParallelEnv()
        self._is_collective = is_collective

    def worker_index(self):
        return self._env.local_rank

    def worker_num(self):
        return max(self._env.nranks, 1)

    def is_first_worker(self):
        return self.worker_index() == 0


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, current_id=0, workers=1, **kw):
        super().__init__()
        self._env._local_rank = current_id
        self._env._nranks = workers


_role_maker = None
_strategy = None


def init(role_maker=None, device=None):
    """Join the process group (`init_parallel_env(device)`)."""
    global _role_maker
    _role_maker = role_maker or PaddleCloudRoleMaker()
    init_parallel_env(device)
    return _role_maker


def worker_index():
    return _role_maker.worker_index() if _role_maker else 0


def worker_num():
    return _role_maker.worker_num() if _role_maker else 1


def is_first_worker():
    return worker_index() == 0 if _role_maker else True


def distributed_optimizer(optimizer, strategy=None):
    """Attach the strategy to the optimizer (fleet_base.py:238);
    `make_train_step` reads it from there."""
    global _strategy
    _strategy = strategy or DistributedStrategy()
    optimizer._fleet_strategy = _strategy
    return optimizer


def get_strategy():
    return _strategy


def _dgc_hyperparams(optimizer):
    """(lr, momentum) of a Momentum or SGD functional optimizer with a
    scalar learning rate (SGD: momentum 0.9, the reference's default)."""
    lr = getattr(optimizer, "_lr", None)
    if not isinstance(optimizer, (Momentum, SGD)) or callable(lr):
        raise ValueError(
            "use_dgc needs an optimizer with scalar hyperparameters "
            "(paddle_tpu_torch.optimizer SGD/Momentum); got "
            f"{type(optimizer).__name__}")
    return float(lr), float(optimizer._attrs.get("mu", 0.9))


def make_train_step(model, optimizer, loss_fn, mesh=None, strategy=None):
    """Build the train step the strategy asks for (CollectiveOptimizer
    .minimize parity, incubate/fleet/collective/__init__.py:182, as a
    step factory):

      use_dgc        -> DGCTrainStep (lr and momentum from the optimizer)
      use_local_sgd  -> LocalSGDTrainStep
      otherwise      -> DataParallelTrainStep
      amp            -> bf16 auto_cast around the loss
      recompute      -> torch.utils.checkpoint around the loss
      dp/tp/pp/sp degrees -> the mesh, when none is passed; the steps
                     run over its dp axis, the other axes replicating
    """
    from .data_parallel import DataParallelTrainStep
    from .mesh import build_mesh, default_mesh
    from .strategies import DGCTrainStep, LocalSGDTrainStep

    strategy = (strategy or getattr(optimizer, "_fleet_strategy", None)
                or DistributedStrategy())
    if mesh is None:
        if strategy.dp_degree or strategy.tp_degree > 1 \
                or strategy.sp_degree > 1 or strategy.pp_degree > 1:
            mesh = build_mesh(dp=strategy.dp_degree or 1,
                              tp=strategy.tp_degree,
                              pp=strategy.pp_degree,
                              sp=strategy.sp_degree)
        else:
            mesh = default_mesh()

    wrapped_loss = loss_fn
    if strategy.amp:
        from ..amp import auto_cast

        def wrapped_loss(m, *batch, _inner=wrapped_loss):
            with auto_cast(enable=True):
                return _inner(m, *batch)
    if strategy.recompute:
        from ..nn.parameter import default_rng

        def wrapped_loss(m, *batch, _inner=wrapped_loss):
            # the recompute draws dropout's bits again from where the
            # forward started
            gen = default_rng.generator(mesh.device)
            rewind = gen.get_state()

            def run(*b):
                gen.set_state(rewind)
                return _inner(m, *b)

            return torch.utils.checkpoint.checkpoint(
                run, *batch, use_reentrant=False)

    if strategy.use_dgc:
        lr, momentum = _dgc_hyperparams(optimizer)
        return DGCTrainStep(model, wrapped_loss, mesh, lr=lr,
                            momentum=momentum,
                            sparsity=strategy.dgc_sparsity,
                            rampup_begin_step=strategy.dgc_rampup_begin_step)
    if strategy.use_local_sgd:
        return LocalSGDTrainStep(model, optimizer, wrapped_loss, mesh,
                                 local_sgd_steps=strategy.local_sgd_steps)
    return DataParallelTrainStep(model, optimizer, wrapped_loss, mesh)


def save_persistables(executor, dirname, main_program=None):
    """Fleet save facade (fleet_base.py save_persistables): rank 0 writes,
    other ranks no-op; the replicated state of one rank is the whole
    model."""
    if not is_first_worker():
        return None
    from .. import io

    return io.save_persistables(executor, dirname,
                                main_program=main_program)


def save_inference_model(executor, dirname, feeded_var_names,
                         target_vars, main_program=None):
    """Fleet export facade (fleet_base.py save_inference_model): rank 0
    writes the pruned serving program and its params."""
    if not is_first_worker():
        return None
    from .. import io

    return io.save_inference_model(dirname, feeded_var_names,
                                   target_vars, executor,
                                   main_program=main_program)
