"""`paddle.dataset` compatibility surface.

The stock dataset zoo lives in `paddle_tpu_torch.datasets` (ONE
implementation — this module aliases it so both reference import paths,
`paddle.dataset.mnist`-style and the plural `datasets` package, resolve
to the same modules).  The industrial tabular feeds (DatasetFactory /
InMemoryDataset / QueueDataset, parity fluid/dataset.py:22) live in
`datasets.multislot` and are re-exported here.
"""

import sys as _sys

from ..datasets import (cifar, conll05, flowers, imdb, imikolov,  # noqa: F401
                        mnist, movielens, multislot, sentiment,
                        uci_housing, voc2012, wmt14, wmt16)
from ..datasets.multislot import (BoxPSDataset, DatasetFactory,  # noqa: F401
                                  InMemoryDataset, QueueDataset)

# make `import paddle_tpu_torch.dataset.mnist`-style submodule imports resolve
for _name in ("mnist", "cifar", "uci_housing", "imdb", "movielens",
              "conll05", "wmt14", "multislot", "flowers", "imikolov",
              "sentiment", "wmt16", "voc2012"):
    _sys.modules[__name__ + "." + _name] = globals()[_name]

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "movielens",
           "conll05", "wmt14", "multislot", "flowers", "imikolov",
           "sentiment", "wmt16", "voc2012", "DatasetFactory",
           "InMemoryDataset", "QueueDataset", "BoxPSDataset"]
