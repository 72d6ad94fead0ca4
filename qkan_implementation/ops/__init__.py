"""Pure-function QKAN step pipeline (DILATE/CHEB -> MUL -> LCU -> SUM).

JAX re-design of the reference's class-per-step OO pipeline
(``QKAN_Steps_original/``): every step is a pure, jit/vmap/grad-compatible
function over arrays; dense NK x NK diagonal matrices are never materialized.
"""

from qkan_implementation.ops.chebyshev import (
    chebyshev_t,
    chebyshev_basis,
    cumulative_transform,
    transform_diagonal,
    dilate,
    dilated_chebyshev_diag,
    check_unit_interval,
    check_weight_magnitudes,
)
from qkan_implementation.ops.qkan_layer import (
    weighted_chebyshev_diag,
    lcu_combine_diag,
    sum_step,
    qkan_layer_forward,
    qkan_layer_forward_batched,
    qkan_layer_forward_batched_int8,
    qkan_intermediates,
)
from qkan_implementation.ops.fused_layer import kan_layer_fused

__all__ = [
    "chebyshev_t",
    "chebyshev_basis",
    "cumulative_transform",
    "transform_diagonal",
    "dilate",
    "dilated_chebyshev_diag",
    "check_unit_interval",
    "check_weight_magnitudes",
    "weighted_chebyshev_diag",
    "lcu_combine_diag",
    "sum_step",
    "qkan_layer_forward",
    "qkan_layer_forward_batched",
    "qkan_layer_forward_batched_int8",
    "qkan_intermediates",
    "kan_layer_fused",
]
