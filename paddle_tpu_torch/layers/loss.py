"""Loss layer functions, static graph builders (port of the static-zoo
slice of paddle_tpu/layers/loss.py; Paddle-Fluid's fluid/layers/loss.py).
"""

from ..framework.layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "square_error_cost"]


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    """-log of the label's probability; `input` holds probabilities."""
    helper = LayerHelper("cross_entropy", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "cross_entropy", inputs={"X": input, "Label": label},
        outputs={"Y": out},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False,
                               axis=-1, name=None):
    helper = LayerHelper("softmax_with_cross_entropy", name=name)
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": logits, "Label": label},
        outputs={"Softmax": softmax, "Loss": loss},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost",
                     inputs={"X": input, "Y": label}, outputs={"Out": out})
    return out

