"""Loss layer functions, static graph builders (port of
paddle_tpu/layers/loss.py; Paddle-Fluid's fluid/layers/loss.py).
"""

from ..framework.layer_helper import LayerHelper

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "square_error_cost", "mse_loss",
    "smooth_l1", "huber_loss", "log_loss", "kldiv_loss", "bce_loss",
]


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
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


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "sigmoid_cross_entropy_with_logits",
        inputs={"X": x, "Label": label}, outputs={"Out": out},
        attrs={"ignore_index": ignore_index, "normalize": normalize})
    return out


def square_error_cost(input, label, name=None):
    helper = LayerHelper("square_error_cost", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square_error_cost",
                     inputs={"X": input, "Y": label}, outputs={"Out": out})
    return out


def mse_loss(input, label, name=None):
    from .tensor import mean

    return mean(square_error_cost(input, label))


def smooth_l1(x, y, sigma=1.0, name=None):
    helper = LayerHelper("smooth_l1_loss", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("smooth_l1_loss", inputs={"X": x, "Y": y},
                     outputs={"Out": out, "Diff": diff},
                     attrs={"sigma": sigma})
    return out


def huber_loss(input, label, delta=1.0, name=None):
    helper = LayerHelper("huber_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("huber_loss", inputs={"X": input, "Y": label},
                     outputs={"Out": out, "Residual": residual},
                     attrs={"delta": delta})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_loss",
                     inputs={"Predicted": input, "Labels": label},
                     outputs={"Loss": out}, attrs={"epsilon": epsilon})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("kldiv_loss", inputs={"X": x, "Target": target},
                     outputs={"Loss": out}, attrs={"reduction": reduction})
    return out


def bce_loss(input, label, name=None):
    helper = LayerHelper("bce_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("bce_loss", inputs={"X": input, "Label": label},
                     outputs={"Out": out})
    return out
