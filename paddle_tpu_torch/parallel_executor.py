"""`fluid.parallel_executor` import-path compatibility (port of
paddle_tpu/parallel_executor.py).

Parity: python/paddle/fluid/parallel_executor.py:28 — the pre-2.0
multi-device data-parallel runner.  The capability lives in
CompiledProgram.with_data_parallel (framework/compiler.py) + Executor;
this facade keeps the old construct-and-run surface so 1.x scripts
(`pe = fluid.ParallelExecutor(use_cuda=True, loss_name=loss.name);
pe.run(fetch_list=[...])`) work unchanged.  `use_cuda=False` runs on the
host (a CPUPlace executor); `places` goes to with_data_parallel.
"""

from .core.place import CPUPlace
from .framework.compiler import CompiledProgram
from .framework.executor import Executor
from .framework.program import default_main_program

__all__ = ["ParallelExecutor"]


class ParallelExecutor:
    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, places=None):
        self._program = (main_program if main_program is not None
                         else default_main_program())
        self._compiled = CompiledProgram(
            self._program).with_data_parallel(
                loss_name=loss_name, build_strategy=build_strategy,
                exec_strategy=exec_strategy,
                share_vars_from=getattr(share_vars_from, "_compiled",
                                        share_vars_from),
                places=places)
        self._exe = Executor(None if use_cuda else CPUPlace())
        self._scope = scope

    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy=True):
        """parallel_executor.py run — feed_dict is the deprecated alias
        the reference still honors."""
        feed = feed if feed is not None else feed_dict
        return self._exe.run(self._compiled, feed=feed,
                             fetch_list=fetch_list, scope=self._scope,
                             return_numpy=return_numpy)

    def drop_local_exe_scopes(self):
        """Scope churn is the reference runtime's concern; kept as a
        no-op for API parity."""
