"""Unit tests for the statevector / unitary engine.

Every gate is checked against a dense-kron NumPy oracle, the role Qiskit Aer
plays in the reference's test suite (``MulStep.py:115-166``).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from qkan_implementation.sim import Circuit, simulate, unitary, zero_state
from qkan_implementation.sim.circuit import ry_matrix


def kron_embed(u, qubits, num_qubits):
    """Dense embedding of a k-qubit gate (qubits[0] = MSB of gate index)
    into the full 2^q space, little-endian global indexing."""
    dim = 2**num_qubits
    k = len(qubits)
    full = np.zeros((dim, dim), dtype=complex)
    for col in range(dim):
        # extract gate-input bits from col
        sub_in = 0
        for pos, t in enumerate(qubits):
            bit = (col >> t) & 1
            sub_in |= bit << (k - 1 - pos)
        rest = col
        for t in qubits:
            rest &= ~(1 << t)
        for sub_out in range(2**k):
            row = rest
            for pos, t in enumerate(qubits):
                bit = (sub_out >> (k - 1 - pos)) & 1
                row |= bit << t
            full[row, col] += u[sub_out, sub_in]
    return full


H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
X = np.array([[0, 1], [1, 0]])
CX = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]])
SWAP = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])


def test_single_qubit_gates_match_kron():
    q = 3
    for t in range(q):
        circ = Circuit(q)
        circ.h(t)
        np.testing.assert_allclose(
            np.asarray(unitary(circ)), kron_embed(H, (t,), q).real, atol=1e-12
        )


def test_cx_convention():
    # cx(control, target): control is the first (MSB) qubit.
    q = 2
    circ = Circuit(q).cx(1, 0)
    u = np.asarray(unitary(circ))
    # |10> (index 2) -> |11> (index 3)
    expected = kron_embed(CX, (1, 0), q).real
    np.testing.assert_allclose(u, expected, atol=1e-12)
    assert expected[3, 2] == 1.0 and expected[2, 3] == 1.0


def test_two_qubit_gates_on_nonadjacent_qubits():
    q = 4
    rng = np.random.default_rng(0)
    for qubits in [(0, 2), (3, 1), (2, 3), (1, 0)]:
        theta = rng.uniform(0, np.pi)
        circ = Circuit(q).cry(theta, *qubits)
        from qkan_implementation.sim.circuit import controlled

        expected = kron_embed(controlled(ry_matrix(theta)), qubits, q).real
        np.testing.assert_allclose(np.asarray(unitary(circ)), expected, atol=1e-12)


def test_swap_matches_kron():
    q = 3
    circ = Circuit(q).swap(0, 2)
    np.testing.assert_allclose(
        np.asarray(unitary(circ)), kron_embed(SWAP, (0, 2), q).real, atol=1e-12
    )


def test_rz_is_complex_and_correct():
    circ = Circuit(1).rz(0.7, 0)
    u = np.asarray(unitary(circ))
    expected = np.diag([np.exp(-0.35j), np.exp(0.35j)])
    np.testing.assert_allclose(u, expected, atol=1e-12)


def test_ghz_state():
    circ = Circuit(3).h(0).cx(0, 1).cx(1, 2)
    psi = np.asarray(simulate(circ))
    expected = np.zeros(8)
    expected[0] = expected[7] = 1 / np.sqrt(2)
    np.testing.assert_allclose(psi, expected, atol=1e-12)


def test_random_circuit_unitarity():
    rng = np.random.default_rng(5)
    q = 4
    circ = Circuit(q)
    for _ in range(30):
        kind = rng.integers(0, 5)
        t = int(rng.integers(0, q))
        c = int((t + 1 + rng.integers(0, q - 1)) % q)
        if kind == 0:
            circ.h(t)
        elif kind == 1:
            circ.ry(float(rng.uniform(0, np.pi)), t)
        elif kind == 2:
            circ.cx(c, t)
        elif kind == 3:
            circ.swap(c, t)
        else:
            circ.cry(float(rng.uniform(0, np.pi)), c, t)
    u = np.asarray(unitary(circ))
    np.testing.assert_allclose(u @ u.T.conj(), np.eye(2**q), atol=1e-10)


def test_ucry_matches_elementary_decomposition():
    # A uniformly-controlled Ry must equal the block-diagonal of Ry(theta_c).
    q = 3
    rng = np.random.default_rng(6)
    thetas = rng.uniform(-np.pi, np.pi, 4)
    circ = Circuit(q).ucry(thetas, controls=(2, 1), target=0)
    u = np.asarray(unitary(circ))
    expected = np.zeros((8, 8))
    for c in range(4):
        # controls (2,1): pattern bit for qubit2 is MSB; target qubit0
        base = ((c >> 1) << 2) | ((c & 1) << 1)
        expected[base : base + 2, base : base + 2] = ry_matrix(thetas[c])
    np.testing.assert_allclose(u, expected, atol=1e-12)


def test_diagonal_gate():
    q = 2
    phases = np.exp(1j * np.array([0.1, 0.2, 0.3, 0.4]))
    circ = Circuit(q).diagonal(phases, (1, 0))
    u = np.asarray(unitary(circ))
    np.testing.assert_allclose(u, np.diag(phases), atol=1e-12)


def test_generic_unitary_gate():
    rng = np.random.default_rng(7)
    m = rng.normal(size=(4, 4))
    qmat, _ = np.linalg.qr(m)
    circ = Circuit(3).unitary(qmat, (2, 0))
    expected = kron_embed(qmat, (2, 0), 3).real
    np.testing.assert_allclose(np.asarray(unitary(circ)), expected, atol=1e-12)


def test_real_circuit_uses_real_dtype():
    circ = Circuit(2).h(0).cx(0, 1)
    psi = simulate(circ)
    assert not np.iscomplexobj(np.asarray(psi))


def test_ry_convention_hardcoded_oracle():
    """Pin the Ry sign convention against an INDEPENDENT hard-coded matrix
    (the other gate oracles are hard-coded, but the ry/cry/ucry tests
    build their expectations from the implementation's own ry_matrix -- a
    sin-sign flip would survive the whole suite otherwise).

    Ry(theta) = [[cos t/2, -sin t/2], [sin t/2, cos t/2]] (Qiskit/reference
    convention: Ry(theta)|0> = cos(t/2)|0> + sin(t/2)|1>)."""
    theta = 0.7
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    circ = Circuit(1)
    circ.ry(theta, 0)
    psi0 = np.asarray(simulate(circ))  # from |0>
    np.testing.assert_allclose(psi0, [c, s], atol=1e-12)
    one = jnp.zeros(2, dtype=jnp.float64).at[1].set(1.0)
    psi1 = np.asarray(simulate(circ, psi0=one))  # from |1>
    np.testing.assert_allclose(psi1, [-s, c], atol=1e-12)
