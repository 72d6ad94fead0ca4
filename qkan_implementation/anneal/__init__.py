"""QUBO construction + on-device batched simulated annealing.

JAX replacement for the reference's pyqubo/cpp_pyqubo (C++ QUBO
compiler) + neal (C++ simulated annealer) stack
(``DegreeOptimizer.py:227-237``, ``KAN_w_cumulative_polynomials.py:148-168``).
"""

from qkan_implementation.anneal.qubo import (
    QuboModel,
    degree_selection_qubo,
    qubo_energy,
    decode_degrees,
)
from qkan_implementation.anneal.sa import (
    greedy_descent,
    parallel_tempering,
    parallel_tempering_mesh_ladder,
    parallel_tempering_sharded,
    simulated_annealing,
    simulated_annealing_sharded,
    default_beta_range,
    default_tempering_beta_range,
    polish_one_hot_blocks,
    solve_qubo,
)
from qkan_implementation.anneal.expr import (
    Array,
    Binary,
    Constraint,
    QuboExpr,
)

__all__ = [
    "QuboModel",
    "degree_selection_qubo",
    "qubo_energy",
    "decode_degrees",
    "greedy_descent",
    "parallel_tempering",
    "parallel_tempering_mesh_ladder",
    "parallel_tempering_sharded",
    "simulated_annealing",
    "simulated_annealing_sharded",
    "default_beta_range",
    "default_tempering_beta_range",
    "polish_one_hot_blocks",
    "solve_qubo",
    "Array",
    "Binary",
    "Constraint",
    "QuboExpr",
]
