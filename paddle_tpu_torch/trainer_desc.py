"""`fluid.trainer_desc` import-path compatibility.

Parity: python/paddle/fluid/trainer_desc.py (TrainerDesc :21,
MultiTrainer :215, DistMultiTrainer :236, PipelineTrainer :260).
The reference fills a trainer_desc.proto message consumed by the C++
TrainerFactory; the port's executor consumes the same knobs
directly (Executor.train_from_dataset), so the desc here is the
JSON-IR analogue: a plain dict with the same field names, which
keeps Fleet/Downpour call sites that configure a TrainerDesc
working unchanged.
"""

import multiprocessing

__all__ = ["TrainerDesc", "MultiTrainer", "DistMultiTrainer",
           "PipelineTrainer"]


class _Desc(dict):
    """Attribute-style dict standing in for the protobuf message."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value


class TrainerDesc:
    def __init__(self):
        self.proto_desc = _Desc(
            thread_num=multiprocessing.cpu_count(),
            fetch_config=_Desc(fetch_var_names=[], fetch_var_str_format=[],
                               print_period=100),
            debug=False, dump_fields=[], dump_param=[],
            check_nan_var_names=[], loss_names=[])
        self._fleet_desc = None
        self._device_worker = None
        self._program = None
        self._infer = False

    def _set_fetch_var_and_info(self, fetch_vars, fetch_info, print_period):
        cfg = self.proto_desc.fetch_config
        for i, v in enumerate(fetch_vars):
            cfg.fetch_var_names.append(v.name)
            cfg.fetch_var_str_format.append(fetch_info[i])
        cfg.print_period = print_period

    def _set_debug(self, debug):
        self.proto_desc.debug = debug

    def _set_thread(self, thread_num):
        self.proto_desc.thread_num = thread_num

    def _set_device_worker(self, device_worker):
        self._device_worker = device_worker

    def _set_infer(self, infer):
        self._infer = infer

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_program(self, program):
        self._program = program

    def _set_use_cvm(self, use_cvm=False):
        self.proto_desc.use_cvm = use_cvm

    def _set_no_cvm(self, no_cvm=False):
        self.proto_desc.no_cvm = no_cvm

    def _set_scale_datanorm(self, scale_datanorm=-1):
        self.proto_desc.scale_datanorm = scale_datanorm

    def _set_dump_slot(self, dump_slot):
        self.proto_desc.dump_slot = dump_slot

    def _set_mpi_rank(self, mpi_rank):
        self.proto_desc.mpi_rank = mpi_rank

    def _set_mpi_size(self, mpi_size):
        self.proto_desc.mpi_size = mpi_size

    def _set_dump_fields(self, dump_fields):
        self.proto_desc.dump_fields.extend(dump_fields)

    def _set_dump_fields_path(self, path):
        self.proto_desc.dump_fields_path = path

    def _set_dump_file_num(self, dump_file_num):
        self.proto_desc.dump_file_num = dump_file_num

    def _set_dump_converter(self, converter):
        self.proto_desc.dump_converter = converter

    def _set_dump_param(self, dump_param):
        self.proto_desc.dump_param.extend(dump_param)

    def _set_thread_barrier(self, thread_barrier):
        self.proto_desc.thread_barrier = thread_barrier

    def _set_check_nan_var_names(self, names):
        self.proto_desc.check_nan_var_names.extend(names)

    def _set_loss_names(self, loss_names):
        self.proto_desc.loss_names.extend(loss_names)

    def _set_adjust_ins_weight(self, config):
        self.proto_desc.adjust_ins_weight = config

    def _set_copy_table_config(self, config):
        self.proto_desc.copy_table_config = config

    def _gen_trainer_desc(self):
        self.proto_desc.device_worker_name = (
            type(self._device_worker).__name__ + "Worker"
            if self._device_worker is not None else None)
        if self._device_worker is not None:
            self._device_worker._gen_worker_desc(self)

    def _desc(self):
        return dict(self.proto_desc, class_name=type(self).__name__)


class MultiTrainer(TrainerDesc):
    """trainer_desc.py:215 — N Hogwild workers in the reference; here
    the thread_num knob sizes the input pipeline while the compiled
    step owns the device parallelism."""

    def _gen_trainer_desc(self):
        self.proto_desc.class_name = "MultiTrainer"
        super()._gen_trainer_desc()


class DistMultiTrainer(TrainerDesc):
    """trainer_desc.py:236 — the PS/Downpour variant."""

    def _gen_trainer_desc(self):
        self.proto_desc.class_name = "DistMultiTrainer"
        super()._gen_trainer_desc()


class PipelineTrainer(TrainerDesc):
    """trainer_desc.py:260 — section pipeline; the port's pipeline
    engine lives in distributed/pipeline.py as one SPMD program."""

    def _gen_trainer_desc(self):
        self.proto_desc.class_name = "PipelineTrainer"
        super()._gen_trainer_desc()
