"""Metric layer functions (port of paddle_tpu/layers/metric_op.py;
Paddle-Fluid's fluid/layers/metric_op.py)."""

from ..framework.layer_helper import LayerHelper

__all__ = ["accuracy"]


def accuracy(input, label, k=1, name=None):
    """Top-k accuracy of predictions `input` against int labels: a top_k
    op, then an accuracy op."""
    helper = LayerHelper("accuracy", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", inputs={"X": input},
                     outputs={"Out": values, "Indices": indices},
                     attrs={"k": k})
    acc = helper.create_variable_for_type_inference("float32")
    correct = helper.create_variable_for_type_inference("int32")
    total = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        "accuracy", inputs={"Out": values, "Indices": indices, "Label": label},
        outputs={"Accuracy": acc, "Correct": correct, "Total": total})
    return acc
