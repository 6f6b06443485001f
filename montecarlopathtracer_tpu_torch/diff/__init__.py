"""Differentiable rendering (the counterpart of
``montecarlopathtracer_tpu/diff``; boundary gradients are not ported
yet)."""

from .grad import (
    PARAM_FIELDS,
    make_loss_fn,
    make_sgd_step,
    merge_params,
    render_image,
    split_params,
    value_and_grad,
)

__all__ = [
    "PARAM_FIELDS",
    "split_params",
    "merge_params",
    "render_image",
    "make_loss_fn",
    "make_sgd_step",
    "value_and_grad",
]
