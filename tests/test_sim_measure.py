"""Measurement/sampling tests for the simulator."""

import numpy as np
import jax
import jax.numpy as jnp

from qkan_implementation.sim import (
    Circuit,
    expectation_diagonal,
    marginal_probabilities,
    probabilities,
    sample_counts,
    simulate,
)


def test_probabilities_normalized():
    psi = simulate(Circuit(3).h(0).cx(0, 1).cx(1, 2))
    p = np.asarray(probabilities(psi))
    np.testing.assert_allclose(p.sum(), 1.0, atol=1e-12)
    np.testing.assert_allclose(p[0], 0.5, atol=1e-12)
    np.testing.assert_allclose(p[7], 0.5, atol=1e-12)


def test_sample_counts_ghz():
    psi = simulate(Circuit(3).h(0).cx(0, 1).cx(1, 2))
    _, counts = sample_counts(psi, shots=2000, key=jax.random.key(0))
    assert set(counts) == {0, 7}
    assert abs(counts[0] - 1000) < 150  # ~binomial(2000, 0.5)


def test_expectation_diagonal():
    # <Z0> on |+> is 0; on |0> is 1.  Z0 diag over 1 qubit: [1, -1]
    z = jnp.asarray([1.0, -1.0])
    psi_plus = simulate(Circuit(1).h(0))
    np.testing.assert_allclose(
        float(expectation_diagonal(psi_plus, z)), 0.0, atol=1e-12
    )
    psi_zero = simulate(Circuit(1))
    np.testing.assert_allclose(
        float(expectation_diagonal(psi_zero, z)), 1.0, atol=1e-12
    )


def test_marginal_probabilities():
    # state |q1 q0> = H(q0): marginal over q0 is uniform, over q1 is [1, 0]
    psi = simulate(Circuit(2).h(0))
    m0 = np.asarray(marginal_probabilities(psi, (0,), 2))
    np.testing.assert_allclose(m0, [0.5, 0.5], atol=1e-12)
    m1 = np.asarray(marginal_probabilities(psi, (1,), 2))
    np.testing.assert_allclose(m1, [1.0, 0.0], atol=1e-12)
    # joint marginal ordering: qubits (1, 0) -> index = q1*2 + q0
    m = np.asarray(marginal_probabilities(psi, (1, 0), 2))
    np.testing.assert_allclose(m, [0.5, 0.5, 0.0, 0.0], atol=1e-12)
