"""Degree-optimizer training stack.

JAX rebuild of the reference's two optimizer variants
(``original_degree_optimizer/`` and ``first_conversion_torch/``) on one code
path: QUBO degree search per network edge, Chebyshev feature transforms with
real caching, lstsq scoring, expanding/time-window CV folds, and
qkan-layer-based prediction.
"""

from qkan_implementation.optim.base import BaseOptimizer
from qkan_implementation.optim.degree_optimizer import DegreeOptimizer, MetricType

__all__ = ["BaseOptimizer", "DegreeOptimizer", "MetricType"]
