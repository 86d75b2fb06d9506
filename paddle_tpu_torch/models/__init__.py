"""Model zoo (port of paddle_tpu/models: LeNet, MLP, the ResNet family
with SE-ResNeXt, BERT, GPT with generation and beam search, Wide&Deep,
Word2Vec, seq2seq, the static zoo and the train-step factories).  GPT
takes mixture-of-experts FFNs (`num_experts > 0`)."""

from .bert import (  # noqa: F401
    BertConfig, BertForPretraining, BertModel, bert_base_config,
    bert_tiny_config)
from .gpt import GPT, GPTBlock, GPTConfig  # noqa: F401
from .lenet import LeNet  # noqa: F401
from .mlp import MLP  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, SEResNeXt, resnet18, resnet34, resnet50)
from .train import TrainState, make_eval_step, make_train_step  # noqa: F401
from .wide_deep import WideDeep  # noqa: F401
from .word2vec import Word2Vec  # noqa: F401

__all__ = [
    "LeNet", "MLP",
    "ResNet", "resnet18", "resnet34", "resnet50", "SEResNeXt",
    "BertConfig", "BertModel", "BertForPretraining", "bert_base_config",
    "GPTConfig", "GPT", "GPTBlock", "WideDeep", "Word2Vec",
    "make_train_step", "make_eval_step", "TrainState",
]
