"""`fluid.trainer_factory` import-path compatibility.

Parity: python/paddle/fluid/trainer_factory.py (TrainerFactory :33,
FetchHandlerMonitor :99).  The factory assembles a TrainerDesc +
DeviceWorker from an optimizer's opt_info dict exactly as the
reference does; FetchHandlerMonitor is a real polling thread over
the framework Scope.
"""

import threading
import time

from .framework.program import Variable
from .trainer_desc import (TrainerDesc, MultiTrainer, DistMultiTrainer,
                           PipelineTrainer)
from .device_worker import (DeviceWorker, Hogwild, DownpourSGD,
                            DownpourSGDOPT, Section)

__all__ = ["TrainerFactory", "FetchHandler", "FetchHandlerMonitor"]

_TRAINERS = {c.__name__: c for c in
             (MultiTrainer, DistMultiTrainer, PipelineTrainer)}
_WORKERS = {c.__name__: c for c in
            (Hogwild, DownpourSGD, DownpourSGDOPT, Section)}


class TrainerFactory:
    def _create_trainer(self, opt_info=None):
        if not opt_info:
            trainer = MultiTrainer()
            trainer._set_device_worker(Hogwild())
            return trainer
        trainer = _TRAINERS[opt_info["trainer"]]()
        device_worker = _WORKERS[opt_info["device_worker"]]()
        for key, setter in [
                ("dump_slot", trainer._set_dump_slot),
                ("mpi_rank", trainer._set_mpi_rank),
                ("mpi_size", trainer._set_mpi_size),
                ("dump_fields", trainer._set_dump_fields),
                ("dump_fields_path", trainer._set_dump_fields_path),
                ("dump_file_num", trainer._set_dump_file_num),
                ("dump_converter", trainer._set_dump_converter),
                ("dump_param", trainer._set_dump_param)]:
            if opt_info.get(key) is not None:
                setter(opt_info[key])
        if "fleet_desc" in opt_info:
            device_worker._set_fleet_desc(opt_info["fleet_desc"])
            trainer._set_fleet_desc(opt_info["fleet_desc"])
            for key, setter in [
                    ("use_cvm", trainer._set_use_cvm),
                    ("no_cvm", trainer._set_no_cvm),
                    ("scale_datanorm", trainer._set_scale_datanorm),
                    ("adjust_ins_weight", trainer._set_adjust_ins_weight),
                    ("copy_table", trainer._set_copy_table_config),
                    ("check_nan_var_names",
                     trainer._set_check_nan_var_names),
                    ("loss_names", trainer._set_loss_names)]:
                if opt_info.get(key) is not None:
                    setter(opt_info[key])
        trainer._set_device_worker(device_worker)
        return trainer


class FetchHandler:
    """Base class users subclass; `handler(fetch_dict)` receives
    {key: value-or-None} every period_secs."""

    def __init__(self, var_dict=None, period_secs=60):
        if var_dict is None:
            raise ValueError("var_dict is required")
        self.var_dict = var_dict
        self.period_secs = period_secs

    def handler(self, fetch_dict):
        raise NotImplementedError(
            "subclass FetchHandler and implement handler()")

    @staticmethod
    def help():
        print("""
class FetchHandlerExample(FetchHandler):
    def handler(self, fetch_dict):
        print(fetch_dict["loss"])
handler = FetchHandlerExample(var_dict={"loss": loss_var}, period_secs=60)
""")


class FetchHandlerMonitor:
    """Polls the scope on a daemon thread; sub-second stop latency so
    tests (and short trainings) do not hang on join."""

    def __init__(self, scope, handler):
        self.fetch_instance = handler
        self.scope = scope
        self.running = False
        self.thread = None

    def _loop(self):
        var_name_to_key = {}
        for key, var in self.fetch_instance.var_dict.items():
            name = var.name if isinstance(var, Variable) else str(var)
            var_name_to_key[name] = key
        elapsed = 0.0
        while self.running:
            time.sleep(0.1)
            elapsed += 0.1
            if elapsed < self.fetch_instance.period_secs:
                continue
            elapsed = 0.0
            # handler receives USER keys (the var_dict keys), like the
            # reference's res_dict[var_name_to_key[name]] conversion
            fetch_dict = {key: self.scope.find_var(name)
                          for name, key in var_name_to_key.items()}
            self.fetch_instance.handler(fetch_dict)

    def start(self):
        self.running = True
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def stop(self):
        self.running = False
        if self.thread is not None:
            self.thread.join(timeout=5)
