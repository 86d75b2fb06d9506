"""`fluid.device_worker` import-path compatibility.

Parity: python/paddle/fluid/device_worker.py (DeviceWorker :21,
Hogwild :72, DownpourSGD :95, DownpourSGDOPT :195, Section :301,
DeviceWorkerFactory :349).  In the reference each class fills the
device-worker section of trainer_desc.proto; the port's executor
runs ONE step per device (host worker threads feed,
the compiled program computes), so these classes carry the same
configuration surface into the dict-based TrainerDesc.
"""

__all__ = ["DeviceWorker", "Hogwild", "DownpourSGD", "DownpourSGDOPT",
           "Section", "DeviceWorkerFactory"]


class DeviceWorker:
    def __init__(self):
        self._program = None
        self._infer = None
        self._fleet_desc = None

    def _set_infer(self, infer=False):
        self._infer = infer

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_program(self, program):
        self._program = program

    def _gen_worker_desc(self, trainer_desc):
        raise NotImplementedError(
            "DeviceWorker should not be used directly; pick Hogwild/"
            "DownpourSGD/Section (device_worker.py:66 parity)")


class Hogwild(DeviceWorker):
    """device_worker.py:72 — lock-free shared-parameter workers; the
    port's analogue is the threaded MultiSlot feed draining into
    the single compiled step."""

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc.proto_desc.device_worker_name = "HogwildWorker"
        if self._infer:
            trainer_desc.proto_desc.hogwild_param = {
                "skip_ops": ["feed", "push_sparse", "push_sparse_v2",
                             "push_dense", "distributed_push_sparse",
                             "send"]}


class DownpourSGD(DeviceWorker):
    """device_worker.py:95 — PS pull/push worker; the sparse tables it
    configures map onto distributed/ps.py sparse_config entries."""

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc.proto_desc.device_worker_name = "DownpourWorker"
        dw = {"sparse_tables": [], "dense_tables": [],
              "skip_ops": [], "push_sparse": not self._infer,
              "push_dense": not self._infer}
        fleet = self._fleet_desc
        if fleet is not None:
            tables = getattr(fleet, "trainer_param", None)
            if tables is not None:
                dw["sparse_tables"] = [
                    getattr(t, "table_id", i)
                    for i, t in enumerate(getattr(tables, "sparse_table", []))]
                dw["dense_tables"] = [
                    getattr(t, "table_id", i)
                    for i, t in enumerate(getattr(tables, "dense_table", []))]
                dw["skip_ops"] = list(getattr(tables, "skip_op", []))
        trainer_desc.proto_desc.downpour_param = dw


class DownpourSGDOPT(DownpourSGD):
    """device_worker.py:195 — Downpour variant with the optimizer
    fused into push; same mapping (csrc/ps_shard.cpp runs
    adagrad-in-push natively)."""

    def _gen_worker_desc(self, trainer_desc):
        super()._gen_worker_desc(trainer_desc)
        trainer_desc.proto_desc.device_worker_name = "DownpourWorkerOpt"


class Section(DeviceWorker):
    """device_worker.py:301 — pipeline section worker; the port's
    pipeline schedule is compiled (distributed/pipeline.py), so this
    records the section program/concurrency config only."""

    def __init__(self, pipeline_config=None):
        super().__init__()
        self._pipeline_config = pipeline_config or {}

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc.proto_desc.device_worker_name = "SectionWorker"
        trainer_desc.proto_desc.section_param = dict(self._pipeline_config)


class DeviceWorkerFactory:
    def _create_device_worker(self, worker_type):
        classes = {c.__name__.lower(): c for c in
                   (Hogwild, DownpourSGD, DownpourSGDOPT, Section)}
        return classes[worker_type.lower()]()
