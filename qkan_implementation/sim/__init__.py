"""JAX statevector / unitary circuit engine.

Replaces the Qiskit Aer C++ simulator the reference leans on for every
quantum-correctness check (``QKAN_Steps_original/*.py`` test classes,
reference ``MulStep.py:115-166``).  Circuits are data (a gate IR), and
simulation is pure JAX: gate application as tensor contractions over a
``(2,)*q`` amplitude tensor, unitary construction as a vmap over identity
columns, fused register passes for the large-q hot path, and a mesh-sharded
statevector for 20+ qubits (``sim.sharded``).
"""

from qkan_implementation.sim.circuit import Circuit, Gate
from qkan_implementation.sim.statevector import (
    simulate,
    unitary,
    apply_gate,
    zero_state,
)
from qkan_implementation.sim.measure import (
    probabilities,
    sample_counts,
    expectation_diagonal,
    marginal_probabilities,
)
from qkan_implementation.sim.sharded import sharded_simulate

__all__ = [
    "Circuit",
    "Gate",
    "simulate",
    "unitary",
    "apply_gate",
    "zero_state",
    "probabilities",
    "sample_counts",
    "expectation_diagonal",
    "marginal_probabilities",
    "sharded_simulate",
]
