"""Model families: FixedKAN (QUBO-structured Chebyshev KAN) + MLP baseline."""

from qkan_implementation.models.fixed_kan import (
    FixedKAN,
    FixedKANConfig,
    kan_apply,
    kan_layer_apply,
)
from qkan_implementation.models.mlp import (
    MLPConfig,
    init_mlp,
    mlp_apply,
    mlp_predict,
    train_mlp,
)

__all__ = [
    "FixedKAN",
    "FixedKANConfig",
    "kan_apply",
    "kan_layer_apply",
    "MLPConfig",
    "init_mlp",
    "mlp_apply",
    "mlp_predict",
    "train_mlp",
]
