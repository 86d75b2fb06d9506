"""Model zoo (port of paddle_tpu/models; ported: GPT, generation and the
ResNet family)."""

from .gpt import GPT, GPTBlock, GPTConfig  # noqa: F401
from .resnet import ResNet, resnet18, resnet34, resnet50  # noqa: F401

__all__ = ["GPT", "GPTBlock", "GPTConfig", "ResNet", "resnet18", "resnet34",
           "resnet50"]
