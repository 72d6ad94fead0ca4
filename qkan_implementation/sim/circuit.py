"""Gate IR: circuits as data, not framework objects.

The reference's quantum layer produces Qiskit ``QuantumCircuit`` objects that
only a C++ simulator can consume (reference ``ChebyshevStep.py:124-128``).
Here a circuit is a plain list of ``Gate`` records -- builders (e.g. FABLE in
``encoding.fable``) emit data, and any engine (dense statevector, fused,
sharded) consumes it.  Qubit convention is little-endian: qubit ``t`` carries
bit weight ``2**t`` in the basis-state index, matching the index semantics the
reference's block-encoding tests rely on (top-left block = low-qubit system
register).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


def _as_param_array(values):
    """Keep traced jax arrays as-is (so circuit params can be differentiated
    through); convert python/numpy inputs to a static float64 array."""
    if hasattr(values, "aval") or type(values).__module__.startswith("jax"):
        return values
    return np.asarray(values).reshape(-1)


@dataclass(frozen=True, eq=False)
class Gate:
    """One gate: a name, target qubit tuple, and static parameters.

    For multi-qubit gates the first qubit in ``qubits`` is the most
    significant bit of the gate matrix's index.  ``params`` is a (possibly
    empty) numpy array of static parameters -- rotation angles, or the packed
    matrix for a generic unitary.

    ``eq=False``: the generated structural __eq__/__hash__ would call
    bool()/hash() on the parameter ARRAYS (ValueError / TypeError for any
    ucry/diag/unitary gate); identity semantics are the usable contract.
    """

    name: str
    qubits: Tuple[int, ...]
    params: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "qubits", tuple(int(q) for q in self.qubits))


class Circuit:
    """A mutable gate-list builder over ``num_qubits`` qubits."""

    def __init__(self, num_qubits: int):
        if num_qubits < 1:
            raise ValueError("Circuit needs at least one qubit")
        self.num_qubits = int(num_qubits)
        self.gates: list[Gate] = []

    # -- elementary gates -------------------------------------------------
    def _check(self, *qubits):
        for q in qubits:
            if not 0 <= q < self.num_qubits:
                raise ValueError(f"Qubit {q} out of range [0, {self.num_qubits})")
        if len(set(qubits)) != len(qubits):
            raise ValueError(f"Duplicate qubits in {qubits}")

    def h(self, t: int):
        self._check(t)
        self.gates.append(Gate("h", (t,)))
        return self

    def x(self, t: int):
        self._check(t)
        self.gates.append(Gate("x", (t,)))
        return self

    def z(self, t: int):
        self._check(t)
        self.gates.append(Gate("z", (t,)))
        return self

    @staticmethod
    def _angle(theta):
        """Concrete angles become floats; traced jax values pass through
        (the differentiable-circuit path)."""
        try:
            return float(theta)
        except TypeError:
            return theta

    def ry(self, theta: float, t: int):
        self._check(t)
        self.gates.append(Gate("ry", (t,), (self._angle(theta),)))
        return self

    def rz(self, theta: float, t: int):
        self._check(t)
        self.gates.append(Gate("rz", (t,), (self._angle(theta),)))
        return self

    def cx(self, control: int, target: int):
        self._check(control, target)
        self.gates.append(Gate("cx", (control, target)))
        return self

    def cz(self, control: int, target: int):
        self._check(control, target)
        self.gates.append(Gate("cz", (control, target)))
        return self

    def cry(self, theta: float, control: int, target: int):
        self._check(control, target)
        self.gates.append(Gate("cry", (control, target), (self._angle(theta),)))
        return self

    def swap(self, a: int, b: int):
        self._check(a, b)
        self.gates.append(Gate("swap", (a, b)))
        return self

    # -- fused / structured gates ----------------------------------------
    def ucry(self, thetas, controls: Tuple[int, ...], target: int):
        """Uniformly-controlled Ry (multiplexed rotation).

        Rotates ``target`` by ``thetas[c]`` where ``c`` is the basis value of
        ``controls`` (controls[0] = most significant).  This is the fused form
        of FABLE's gray-code Ry/CNOT ladder -- one vectorized elementwise op
        instead of 2*4^n elementary gates.
        """
        self._check(target, *controls)
        thetas = _as_param_array(thetas)
        if thetas.shape[-1] != 2 ** len(controls):
            raise ValueError(
                f"ucry needs 2**{len(controls)} angles, got {thetas.shape[-1]}"
            )
        self.gates.append(Gate("ucry", (target, *controls), thetas))
        return self

    def diagonal(self, phases, qubits: Tuple[int, ...]):
        """Diagonal gate over ``qubits``: multiplies amplitude of pattern c
        by ``phases[c]`` (qubits[0] = most significant)."""
        self._check(*qubits)
        phases = _as_param_array(phases)
        if phases.shape[-1] != 2 ** len(qubits):
            raise ValueError("diagonal needs 2**k entries")
        self.gates.append(Gate("diag", tuple(qubits), phases))
        return self

    def unitary(self, matrix, qubits: Tuple[int, ...]):
        """Generic k-qubit unitary (row-major 2^k x 2^k matrix)."""
        self._check(*qubits)
        if not hasattr(matrix, "shape"):
            matrix = np.asarray(matrix)
        dim = 2 ** len(qubits)
        if matrix.shape != (dim, dim):
            raise ValueError(f"unitary matrix must be {dim}x{dim}")
        self.gates.append(Gate("unitary", tuple(qubits), matrix))
        return self

    # -- metadata ---------------------------------------------------------
    def __len__(self):
        return len(self.gates)

    @property
    def gate_count(self) -> int:
        return len(self.gates)

    def depth(self) -> int:
        """Circuit depth: longest chain of gates sharing qubits."""
        level = [0] * self.num_qubits
        for g in self.gates:
            d = 1 + max(level[q] for q in g.qubits)
            for q in g.qubits:
                level[q] = d
        return max(level) if self.gates else 0

    def __repr__(self):
        return (
            f"Circuit(num_qubits={self.num_qubits}, gates={len(self.gates)}, "
            f"depth={self.depth()})"
        )


# Static 2x2 / 4x4 gate matrices (numpy, promoted to the sim dtype on use)
_SQ2 = 1.0 / np.sqrt(2.0)
GATE_MATRICES = {
    "h": np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]]),
    "x": np.array([[0.0, 1.0], [1.0, 0.0]]),
    "z": np.array([[1.0, 0.0], [0.0, -1.0]]),
}


def ry_matrix(theta: float) -> np.ndarray:
    if hasattr(theta, "aval"):  # traced angle: build the matrix with jnp
        import jax.numpy as jnp

        c, s = jnp.cos(theta / 2.0), jnp.sin(theta / 2.0)
        return jnp.stack([jnp.stack([c, -s]), jnp.stack([s, c])])
    c, s = np.cos(theta / 2.0), np.sin(theta / 2.0)
    return np.array([[c, -s], [s, c]])


def rz_matrix(theta: float) -> np.ndarray:
    if hasattr(theta, "aval"):
        import jax.numpy as jnp

        z = jnp.zeros((), dtype=jnp.complex128)
        return jnp.diag(
            jnp.stack([jnp.exp(-0.5j * theta) + z, jnp.exp(0.5j * theta) + z])
        )
    return np.diag([np.exp(-0.5j * theta), np.exp(0.5j * theta)])


def controlled(u2: np.ndarray) -> np.ndarray:
    """4x4 controlled version of a 2x2 gate; first qubit (MSB) is control."""
    m = np.eye(4, dtype=np.result_type(u2.dtype, np.float64))
    m[2:, 2:] = u2
    return m


SWAP_MATRIX = np.array(
    [
        [1, 0, 0, 0],
        [0, 0, 1, 0],
        [0, 1, 0, 0],
        [0, 0, 0, 1],
    ],
    dtype=np.float64,
)
