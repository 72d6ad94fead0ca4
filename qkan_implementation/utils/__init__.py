"""Shared utilities: metrics, profiling, checkpoint helpers."""

from qkan_implementation.utils.metrics import (
    mse,
    r2_score,
    weighted_competition_r2,
    compute_metrics,
)

__all__ = ["mse", "r2_score", "weighted_competition_r2", "compute_metrics"]
