"""The statevector engine's streaming paths -- multiplexed Ry, diagonal,
Hadamard walls -- against dense NumPy oracles at 11-12 qubits.

These are the paths XLA fuses into one elementwise loop each on the GPU
(no hand-written kernel): every case runs through ``simulate`` or
``apply_gate`` exactly as the block-encoding workloads do.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qkan_implementation.encoding import fable
from qkan_implementation.sim import Circuit, simulate, unitary
from qkan_implementation.sim.circuit import Gate
from qkan_implementation.sim.fusion import (
    HRegister,
    apply_h_register,
    simulate_fable_runtime,
)
from qkan_implementation.sim.statevector import apply_gate


def _ucry_oracle(psi, thetas, target, controls, q):
    """Multiplexed Ry by explicit pattern loop: for each control pattern,
    rotate the (target=0, target=1) amplitude pairs."""
    psi = np.array(psi, dtype=np.float64, copy=True)
    idx = np.arange(2**q)
    pattern = np.zeros_like(idx)
    for i, c in enumerate(controls):
        pattern |= ((idx >> c) & 1) << (len(controls) - 1 - i)
    lo = idx[((idx >> target) & 1) == 0]
    hi = lo | (1 << target)
    half = np.asarray(thetas)[pattern[lo]] / 2.0
    c, s = np.cos(half), np.sin(half)
    p0, p1 = psi[lo].copy(), psi[hi].copy()
    psi[lo] = c * p0 - s * p1
    psi[hi] = s * p0 + c * p1
    return psi


def _h_oracle(psi, qubit, q):
    v = np.asarray(psi).reshape(2 ** (q - qubit - 1), 2, 2**qubit)
    a, b = v[:, 0, :], v[:, 1, :]
    return np.stack([a + b, a - b], axis=1).reshape(-1) / np.sqrt(2.0)


def _state(rng, q):
    psi = rng.standard_normal(2**q)
    return psi / np.linalg.norm(psi)


@pytest.mark.parametrize("q", [11, 12])
def test_ucry_msb_full_register_matches_oracle(q):
    """FABLE's layout: target the MSB, every other qubit a control (the
    gather-free contiguous [2, half] view)."""
    rng = np.random.default_rng(q)
    psi = _state(rng, q)
    thetas = rng.uniform(-np.pi, np.pi, 2 ** (q - 1))
    controls = tuple(range(q - 2, -1, -1))
    got = apply_gate(jnp.asarray(psi), Gate("ucry", (q - 1,) + controls, thetas), q)
    want = _ucry_oracle(psi, thetas, q - 1, controls, q)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


@pytest.mark.parametrize(
    "target,controls", [(3, (9, 0, 5)), (0, (10,)), (7, (1, 2, 3, 4, 5, 6))]
)
def test_ucry_partial_controls_match_oracle(target, controls):
    q = 11
    rng = np.random.default_rng(target)
    psi = _state(rng, q)
    thetas = rng.uniform(-np.pi, np.pi, 2 ** len(controls))
    got = apply_gate(
        jnp.asarray(psi), Gate("ucry", (target,) + controls, thetas), q
    )
    want = _ucry_oracle(psi, thetas, target, controls, q)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


def test_diag_matches_oracle():
    q = 11
    rng = np.random.default_rng(1)
    psi = _state(rng, q)
    phases = rng.uniform(-1, 1, 2**q)
    full = tuple(range(q - 1, -1, -1))
    got = apply_gate(jnp.asarray(psi), Gate("diag", full, phases), q)
    np.testing.assert_allclose(np.asarray(got), psi * phases, atol=1e-12)
    # a diagonal on a qubit subset gathers its phase per amplitude
    sub = rng.uniform(-1, 1, 4)
    got = apply_gate(jnp.asarray(psi), Gate("diag", (8, 2), sub), q)
    idx = np.arange(2**q)
    want = psi * sub[((idx >> 8) & 1) * 2 + ((idx >> 2) & 1)]
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-12)


@pytest.mark.parametrize("qubit", [7, 9, 10])
def test_h_gate_matches_oracle(qubit):
    q = 11
    rng = np.random.default_rng(2)
    psi = _state(rng, q)
    circ = Circuit(q)
    circ.h(qubit)
    got = simulate(circ, psi0=jnp.asarray(psi), backend="xla")
    np.testing.assert_allclose(np.asarray(got), _h_oracle(psi, qubit, q), atol=1e-12)


def test_h_register_matches_per_gate_walls():
    """One register contraction (split into <= 2^10 blocks) equals the
    per-qubit Hadamards, including a wall wider than ten qubits."""
    q = 12
    rng = np.random.default_rng(3)
    psi = _state(rng, q)
    qubits = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
    got = np.asarray(apply_h_register(jnp.asarray(psi), HRegister(qubits), q))
    want = psi
    for t in qubits:
        want = _h_oracle(want, t, q)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_fable_simulation_matches_block_encoding_contract():
    """End to end: the fused executor's block encoding of a 32x32 matrix
    reproduces A (the reference's U[:N,:N] * alpha * N contract)."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (32, 32))
    circ, alpha = fable(a)
    u = np.asarray(unitary(circ))
    np.testing.assert_allclose(u[:32, :32] * alpha * 32, a, atol=1e-10)


def test_fable_runtime_matches_static_circuit():
    """The runtime-parameter executor (cos/sin as operands) equals the
    static circuit's fused simulation at 13 qubits."""
    from qkan_implementation.encoding.fable import fable_runtime_params

    rng = np.random.default_rng(9)
    a = rng.uniform(-1, 1, (64, 64))
    circ, _ = fable(a)
    cs, sn, _alpha, n = fable_runtime_params(a)
    got = np.asarray(simulate_fable_runtime(jnp.asarray(cs), jnp.asarray(sn), n))
    want = np.asarray(simulate(circ, backend="auto"))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_ucry_is_differentiable():
    """Gradients through the multiplexed Ry w.r.t. angles and state equal
    those of the explicit rotation written out in jnp."""
    q = 11
    rng = np.random.default_rng(5)
    psi = jnp.asarray(_state(rng, q))
    thetas = jnp.asarray(rng.uniform(-np.pi, np.pi, 2 ** (q - 1)))
    controls = tuple(range(q - 2, -1, -1))

    def engine(p, t):
        return jnp.sum(apply_gate(p, Gate("ucry", (q - 1,) + controls, t), q) ** 3)

    def explicit(p, t):
        v = p.reshape(2, -1)
        c, s = jnp.cos(t / 2), jnp.sin(t / 2)
        return jnp.sum(jnp.concatenate([c * v[0] - s * v[1], s * v[0] + c * v[1]]) ** 3)

    ge = jax.grad(engine, argnums=(0, 1))(psi, thetas)
    gx = jax.grad(explicit, argnums=(0, 1))(psi, thetas)
    for a, b in zip(ge, gx):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_simulate_rejects_unknown_backend():
    with pytest.raises(ValueError, match="backend"):
        simulate(Circuit(2).h(0), backend="pallas")
