"""Differentiable rendering (the counterpart of
``montecarlopathtracer_tpu/diff``): parameter gradients of renders, and
the edge-sampled boundary gradients of geometry."""

from .boundary import (
    boundary_grad_translation,
    boundary_grad_vertices,
    make_translation_problem,
    shadow_boundary_grad_translation,
    shadow_boundary_grad_vertices,
    unique_edges,
)
from .grad import (
    PARAM_FIELDS,
    AdamState,
    graphed_loss,
    make_adam_step,
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
    "make_adam_step",
    "AdamState",
    "graphed_loss",
    "value_and_grad",
    "unique_edges",
    "boundary_grad_vertices",
    "boundary_grad_translation",
    "shadow_boundary_grad_vertices",
    "shadow_boundary_grad_translation",
    "make_translation_problem",
]
