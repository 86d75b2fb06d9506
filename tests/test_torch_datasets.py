"""The port's dataset zoo, MultiSlot datasets, data generator and trainer
descriptors against the JAX package's.

- Each synthetic dataset's first samples for its fixed seed are equal to
  the reference's (arrays bitwise), and so are the vocabularies.
- `DataFeedDesc` parses the reference's prototxt, mutates and emits the
  same text; the trainer and device-worker descriptors
  (`TrainerFactory`, MultiTrainer / DistMultiTrainer / PipelineTrainer,
  Hogwild / DownpourSGD / Section) equal the reference's dicts.
- The data generators write the reference's bytes.
- QueueDataset and InMemoryDataset batches over the same MultiSlot files
  equal the reference's (one reader thread, so the order is the files';
  InMemoryDataset shuffled under a seed), over the port's native reader.
- `paddle_tpu_torch.dataset` aliases the zoo as the reference does.
"""

import io
import sys

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.datasets as jds

import paddle_tpu_torch
import paddle_tpu_torch.datasets as tds
from torch_threads import torch_threads  # noqa: F401

N_SAMPLES = 4

READERS = [
    ("mnist", "train", ()), ("mnist", "test", ()),
    ("cifar", "train10", ()), ("cifar", "test100", ()),
    ("uci_housing", "train", ()), ("uci_housing", "test", ()),
    ("imdb", "train", ()), ("imdb", "test", ()),
    ("imikolov", "train", ()), ("movielens", "train", ()),
    ("movielens", "test", ()), ("conll05", "test", ()),
    ("wmt14", "train", ()), ("wmt14", "test", ()),
    ("wmt16", "train", (100, 120)), ("wmt16", "validation", (100, 120)),
    ("flowers", "train", ()), ("flowers", "valid", ()),
    ("sentiment", "train", ()), ("voc2012", "train", ()),
    ("voc2012", "val", ()), ("mq2007", "train", ()),
]
DICTS = [("imdb", "word_dict", ()), ("conll05", "get_dict", ()),
         ("sentiment", "get_word_dict", ()), ("imikolov", "build_dict", ()),
         ("wmt16", "get_dict", ("de", 50)), ("movielens", "max_user_id", ()),
         ("movielens", "max_movie_id", ()), ("movielens", "max_job_id", ())]


def _equal(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


@pytest.mark.parametrize("mod,fn,args", READERS,
                         ids=[f"{m}.{f}" for m, f, _ in READERS])
def test_reader_samples_equal_the_reference(mod, fn, args):
    want = getattr(getattr(jds, mod), fn)(*args)
    got = getattr(getattr(tds, mod), fn)(*args)
    # a reader creator, or (mq2007) the generator itself
    want = want() if callable(want) else want
    got = got() if callable(got) else got
    for _ in range(N_SAMPLES):
        _equal(next(got), next(want))


@pytest.mark.parametrize("mod,fn,args", DICTS,
                         ids=[f"{m}.{f}" for m, f, _ in DICTS])
def test_vocabularies_equal_the_reference(mod, fn, args):
    _equal(getattr(getattr(tds, mod), fn)(*args),
           getattr(getattr(jds, mod), fn)(*args))


def test_namespaces_and_aliases_match():
    assert tds.__all__ == jds.__all__
    import paddle_tpu.dataset as jdataset
    import paddle_tpu_torch.dataset as tdataset

    assert tdataset.__all__ == jdataset.__all__
    assert tdataset.mnist is tds.mnist
    assert sys.modules["paddle_tpu_torch.dataset.mnist"] is tds.mnist
    assert tdataset.QueueDataset is tds.multislot.QueueDataset
    assert set(dir(tds.common)) >= {"download", "md5file", "split",
                                    "cluster_files_reader", "fetch_all"}


PROTO = ('name: "MultiSlotDataFeed"\n'
         "batch_size: 2\n"
         "multi_slot_desc {\n"
         "  slots {\n"
         '    name: "words"\n'
         '    type: "uint64"\n'
         "    is_dense: false\n"
         "    is_used: false\n"
         "  }\n"
         "  slots {\n"
         '    name: "label"\n'
         '    type: "float"\n'
         "    is_dense: true\n"
         "    is_used: false\n"
         "  }\n"
         "}\n")


def test_data_feed_desc_round_trips_the_reference_prototxt(tmp_path):
    from paddle_tpu.data_feed_desc import DataFeedDesc as JDesc

    from paddle_tpu_torch.data_feed_desc import DataFeedDesc as TDesc

    proto = tmp_path / "data.proto"
    proto.write_text(PROTO)
    j, t = JDesc(str(proto)), TDesc(str(proto))
    assert t.proto_desc == j.proto_desc
    for d in (j, t):
        d.set_batch_size(128)
        d.set_dense_slots(["words"])
        d.set_use_slots(["words", "label"])
    assert t.desc() == j.desc()
    again = tmp_path / "again.proto"
    again.write_text(t.desc())
    assert TDesc(str(again)).proto_desc == t.proto_desc


class _Var:
    def __init__(self, name):
        self.name = name


class _Table:
    def __init__(self, table_id):
        self.table_id = table_id


class _Fleet:
    class trainer_param:
        sparse_table = [_Table(3), _Table(5)]
        dense_table = [_Table(7)]
        skip_op = ["lookup_table"]


OPT_INFOS = [
    None,
    {"trainer": "DistMultiTrainer", "device_worker": "DownpourSGD",
     "dump_slot": True, "mpi_rank": 3, "mpi_size": 4,
     "dump_fields": ["a"], "dump_fields_path": "/x", "dump_file_num": 2,
     "dump_converter": "cat", "dump_param": ["w"]},
    {"trainer": "DistMultiTrainer", "device_worker": "DownpourSGDOPT",
     "fleet_desc": _Fleet, "use_cvm": True, "no_cvm": False,
     "scale_datanorm": 0.5, "adjust_ins_weight": {"on": 1},
     "copy_table": {"t": 1}, "check_nan_var_names": ["loss"],
     "loss_names": ["loss"]},
    {"trainer": "PipelineTrainer", "device_worker": "Section"},
    {"trainer": "MultiTrainer", "device_worker": "Hogwild"},
]


@pytest.mark.parametrize("opt_info", OPT_INFOS,
                         ids=["default", "downpour", "downpour_opt",
                              "pipeline", "hogwild"])
@pytest.mark.parametrize("infer", [False, True])
def test_trainer_descriptors_equal_the_reference(opt_info, infer):
    from paddle_tpu.trainer_factory import TrainerFactory as JF

    from paddle_tpu_torch.trainer_factory import TrainerFactory as TF

    descs = []
    for factory in (JF, TF):
        tr = factory()._create_trainer(opt_info)
        tr._set_fetch_var_and_info([_Var("loss")], ["loss"],
                                   print_period=10)
        tr._set_debug(True)
        tr._set_thread(3)
        tr._set_infer(infer)
        tr._device_worker._set_infer(infer)
        tr._gen_trainer_desc()
        descs.append((type(tr).__name__, type(tr._device_worker).__name__,
                      tr._desc()))
    assert descs[1] == descs[0]


def test_device_worker_factory_matches():
    from paddle_tpu.device_worker import DeviceWorkerFactory as J

    from paddle_tpu_torch.device_worker import DeviceWorkerFactory as T

    for name in ("Hogwild", "DownpourSGD", "Section"):
        assert type(T()._create_device_worker(name)).__name__ == \
            type(J()._create_device_worker(name)).__name__


def _generators(pkg):
    dg = pkg.incubate.data_generator

    class Numeric(dg.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                r = np.random.default_rng(int(line or 0))
                for _ in range(5):
                    yield [("ids", [int(v) for v in r.integers(0, 99, 3)]),
                           ("dense", [float(v) for v in r.normal(size=2)]),
                           ("label", [int(r.integers(0, 2))])]
            return it

    class Words(dg.MultiSlotStringDataGenerator):
        def generate_sample(self, line):
            def it():
                yield [("words", (line or "a b c").split()),
                       ("label", ["1"])]
            return it

        def generate_batch(self, samples):
            def it():
                for s in reversed(samples):
                    yield s
            return it

    return Numeric, Words


def test_data_generators_write_the_reference_bytes(monkeypatch):
    outs = []
    for pkg in (paddle_tpu, paddle_tpu_torch):
        numeric, words = _generators(pkg)
        buf = io.StringIO()
        g = numeric()
        g.set_batch(2)
        g.run_from_memory(buf)
        monkeypatch.setattr(sys, "stdin", io.StringIO("3\n7\n"))
        g2 = numeric()
        g2.run_from_stdin(buf)
        w = words()
        w.set_batch(3)
        monkeypatch.setattr(sys, "stdin", io.StringIO("x y\nz\nu v w\n"))
        w.run_from_stdin(buf)
        outs.append((buf.getvalue(), g._proto_info))
    assert outs[1] == outs[0]
    assert "3 " in outs[0][0]


def _files(tmp_path, n_files=2, lines=20):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n_files):
        p = tmp_path / f"part-{i}"
        with open(p, "w") as f:
            for _ in range(lines):
                ids = rng.integers(0, 50, 3)
                feat = rng.normal(size=2)
                f.write(f"3 {ids[0]} {ids[1]} {ids[2]} "
                        f"2 {feat[0]:.5f} {feat[1]:.5f} "
                        f"1 {int(ids.sum()) % 2}\n")
        paths.append(str(p))
    return paths


def _dataset(cls, paths, batch):
    ds = cls()
    ds.set_filelist(paths)
    ds.set_batch_size(batch)
    ds.set_thread(1)
    ds.set_use_var([("ids", "int64", 3), ("feat", "float32", 2),
                    ("label", "int64", 1)])
    return ds


def _batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_queue_dataset_batches_equal_the_reference(tmp_path):
    from paddle_tpu.datasets.multislot import QueueDataset as J

    from paddle_tpu_torch.datasets.multislot import QueueDataset as T

    paths = _files(tmp_path)
    _batches_equal(list(_dataset(T, paths, 6)), list(_dataset(J, paths, 6)))
    with pytest.raises(NotImplementedError, match="shuffle"):
        _dataset(T, paths, 6).local_shuffle()


@pytest.mark.parametrize("name", ["InMemoryDataset", "BoxPSDataset"])
def test_in_memory_dataset_batches_equal_the_reference(tmp_path, name):
    from paddle_tpu.datasets.multislot import DatasetFactory as J

    from paddle_tpu_torch.datasets.multislot import DatasetFactory as T

    paths = _files(tmp_path)
    sets = []
    for factory in (J, T):
        ds = factory().create_dataset(name)
        ds.set_filelist(paths)
        ds.set_batch_size(7)
        ds.set_thread(1)
        ds.set_use_var([("ids", "int64", 3), ("feat", "float32", 2),
                        ("label", "int64", 1)])
        ds.load_into_memory()
        ds.local_shuffle(seed=5)
        assert len(ds) == 40
        sets.append(list(ds))
    _batches_equal(sets[1], sets[0])
