"""Dense statevector / unitary simulation of gate-IR circuits.

The JAX replacement for Qiskit Aer's ``unitary_simulator`` (the
reference's only quantum runtime, ``MulStep.py:115-166``).  Amplitudes live
in a flat ``[2**q]`` array viewed as a ``(2,)*q`` tensor during gate
application; every gate is a (batched) tensor contraction or fused
elementwise op, so the whole circuit jit-compiles into one XLA program.
Unitary construction = vmap over identity columns.

Real circuits (H/X/Ry/CNOT/SWAP/UCRY -- everything FABLE emits) simulate in
real dtype, halving bandwidth; complex circuits promote automatically.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qkan_implementation.sim.circuit import (
    Circuit,
    Gate,
    GATE_MATRICES,
    SWAP_MATRIX,
    controlled,
    ry_matrix,
    rz_matrix,
)

_REAL_GATES = {"h", "x", "z", "ry", "cx", "cz", "cry", "swap", "ucry"}


def circuit_is_real(circuit: Circuit) -> bool:
    """True if every gate has a real matrix (so real-dtype simulation is exact)."""
    for g in circuit.gates:
        if g.name in _REAL_GATES:
            continue
        if g.name in ("diag", "unitary"):
            dtype = getattr(g.params, "dtype", None)
            if dtype is not None:
                if np.issubdtype(dtype, np.complexfloating):
                    return False
            elif not np.isrealobj(np.asarray(g.params)):
                return False
            continue
        return False
    return True


def default_dtype(circuit: Circuit):
    x64 = jax.config.jax_enable_x64
    if circuit_is_real(circuit):
        return jnp.float64 if x64 else jnp.float32
    return jnp.complex128 if x64 else jnp.complex64


def zero_state(num_qubits: int, dtype=None) -> jax.Array:
    dtype = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    psi = jnp.zeros(2**num_qubits, dtype=dtype)
    return psi.at[0].set(1.0)


def _gate_matrix(gate: Gate) -> np.ndarray:
    """Dense matrix of any non-fused gate (numpy, float64/complex128)."""
    if gate.name in GATE_MATRICES:
        return GATE_MATRICES[gate.name]
    if gate.name == "ry":
        return ry_matrix(gate.params[0])
    if gate.name == "rz":
        return rz_matrix(gate.params[0])
    if gate.name == "cx":
        return controlled(GATE_MATRICES["x"])
    if gate.name == "cz":
        return controlled(GATE_MATRICES["z"])
    if gate.name == "cry":
        return controlled(ry_matrix(gate.params[0]))
    if gate.name == "swap":
        return SWAP_MATRIX
    if gate.name == "unitary":
        dim = 2 ** len(gate.qubits)
        return jnp.asarray(gate.params).reshape(dim, dim)
    raise ValueError(f"Unknown gate {gate.name}")


def _grouped_view(num_qubits: int, qubits):
    """Shape for viewing a flat [2^q] state with one explicit axis per gate
    qubit and merged segments in between: at most 2k+1 dims total, so XLA
    never sees a rank-q tensor (rank-20+ transposes blow up compile time).

    Returns (shape, axis_of_qubit dict).  Qubits must be sorted descending.
    """
    shape = []
    axes = {}
    prev = num_qubits
    for t in qubits:
        seg = 2 ** (prev - t - 1)
        if seg > 1:
            shape.append(seg)
        axes[t] = len(shape)
        shape.append(2)
        prev = t
    if prev > 0:
        shape.append(2**prev)
    return shape, axes


def _apply_dense(psi, matrix, qubits, num_qubits):
    """Apply a k-qubit dense gate to the flat [2^q] state ``psi``.

    ``qubits[0]`` is the most significant bit of the gate index.  The state
    is viewed with one axis per gate qubit (plus merged segments), the gate
    contracts those axes, and the axes move back in place -- all on tensors
    of rank <= 2k+1.
    """
    k = len(qubits)
    order = sorted(qubits, reverse=True)
    shape, axes = _grouped_view(num_qubits, order)
    psi_v = psi.reshape(shape)
    contract_axes = [axes[t] for t in qubits]
    m = jnp.asarray(matrix, dtype=psi.dtype).reshape((2,) * (2 * k))
    # HIGHEST precision: an f32 contraction may otherwise run in TF32 on
    # the GPU (~1e-3 per gate); the contraction is tiny, exactness is the
    # contract.
    out = jnp.tensordot(
        m,
        psi_v,
        axes=(list(range(k, 2 * k)), contract_axes),
        precision=jax.lax.Precision.HIGHEST,
    )
    # tensordot puts the gate's output axes first, in qubits order
    out = jnp.moveaxis(out, list(range(k)), contract_axes)
    return out.reshape(psi.shape)


def _pattern_index(qubits, size, skip_bit: int | None = None):
    """Parameter index per flat position: read the ``qubits`` bits of each
    index in [0, size) (qubits[0] = MSB of the parameter index).

    ``skip_bit``: the flat index enumerates a state with that qubit removed
    (bit positions above it shift down by one).  Pure int32 bit arithmetic --
    one gather instead of a (2,)*k reshape/transpose, keeping XLA compile
    time flat in qubit count.
    """
    r = np.arange(size, dtype=np.int64)
    c_index = np.zeros_like(r)
    k = len(qubits)
    for i, t in enumerate(qubits):
        pos = t if skip_bit is None or t < skip_bit else t - 1
        bit = (r >> pos) & 1
        c_index = c_index | (bit << (k - 1 - i))
    return c_index  # static numpy: a constant to XLA


def _apply_ucry(psi, thetas, target, controls, num_qubits):
    """Fused uniformly-controlled Ry: one vectorized elementwise update.

    Equivalent to FABLE's 2*4^n Ry/CNOT gray-code ladder but O(2^q) work in
    a single streaming elementwise op -- the hot path of block-encoding
    simulation.
    Operates on the flat state via an [outer, 2, inner] view (never rank-q).
    """
    q = num_qubits
    shape = psi.shape
    inner = 2**target
    v = psi.reshape(-1, 2, inner)  # [outer, 2, inner]
    p0 = v[:, 0, :].reshape(-1)
    p1 = v[:, 1, :].reshape(-1)

    c_index = _pattern_index(controls, p0.shape[0], skip_bit=target)
    th = jnp.asarray(thetas).reshape(-1)
    if th.shape[0] == p0.shape[0] and np.array_equal(
        c_index, np.arange(p0.shape[0])
    ):
        # FABLE's layout (controls = all rest qubits, MSB first) needs no
        # gather at all -- the angle order IS the amplitude order.
        half = th / 2.0
    else:
        half = th[c_index] / 2.0
    c = jnp.cos(half).astype(psi.dtype)
    s = jnp.sin(half).astype(psi.dtype)
    new0 = (c * p0 - s * p1).reshape(-1, inner)
    new1 = (s * p0 + c * p1).reshape(-1, inner)
    return jnp.stack([new0, new1], axis=1).reshape(shape)


def _apply_diag(psi, phases, qubits, num_qubits):
    """Fused diagonal gate: elementwise multiply via one parameter gather."""
    shape = psi.shape
    flat = psi.reshape(-1)
    ph = jnp.asarray(phases).reshape(-1)
    if ph.shape[0] == flat.shape[0] and tuple(qubits) == tuple(
        range(num_qubits - 1, -1, -1)
    ):
        return (flat * ph.astype(flat.dtype)).reshape(shape)
    c_index = _pattern_index(qubits, flat.shape[0])
    return (flat * ph[c_index].astype(flat.dtype)).reshape(shape)


def apply_gate(psi: jax.Array, gate: Gate, num_qubits: int) -> jax.Array:
    """Apply one gate to a flat [2**q] statevector."""
    if gate.name == "ucry":
        target, controls = gate.qubits[0], gate.qubits[1:]
        return _apply_ucry(psi, gate.params, target, controls, num_qubits)
    if gate.name == "diag":
        return _apply_diag(psi, gate.params, gate.qubits, num_qubits)
    return _apply_dense(psi, _gate_matrix(gate), gate.qubits, num_qubits)


# Unroll-vs-scan crossover for Ry/CNOT ladders (elementary FABLE emits
# 2*4^n of them).  Measured on CPU x64: unrolled tracing costs ~1.5s at 524
# gates and ~8s at 2063 (superlinear), while the scan executor compiles in
# ~1s flat at any length.  Runs >= this length scan-fuse under
# backend='auto'; exec cost is ~us/gate.
AUTO_LADDER_MIN = 128


def simulate(
    circuit: Circuit,
    psi0: jax.Array | None = None,
    dtype=None,
    backend: str = "auto",
) -> jax.Array:
    """Run ``circuit`` on ``psi0`` (default |0...0>); returns the final state.

    The gate loop unrolls at trace time (the circuit is static data), so under
    ``jax.jit`` the whole circuit fuses into one XLA computation -- except
    long Ry/CNOT ladder runs (elementary FABLE circuits trace 2*4^n gates),
    which ``backend='auto'`` executes as ONE ``lax.scan`` each so compile
    time stays O(1) in ladder length (see ``sim.ladder``; threshold
    ``AUTO_LADDER_MIN`` from the measured unroll-vs-scan crossover).

    ``backend``: 'auto' also fuses H walls and swap runs into register
    ops (``sim.fusion``) and scan-fuses long ladders; 'xla' applies the
    gates one by one, fully unrolled -- the unfused oracle.
    """
    if backend not in ("auto", "xla"):
        raise ValueError(f"unknown backend {backend!r}: 'auto' or 'xla'")
    if dtype is None:
        dtype = default_dtype(circuit)
        # inferred dtype covers the CIRCUIT; a complex initial state must
        # promote it or .astype silently drops the imaginary part
        if psi0 is not None and jnp.issubdtype(
            jnp.asarray(psi0).dtype, jnp.complexfloating
        ) and not jnp.issubdtype(dtype, jnp.complexfloating):
            dtype = (
                jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64
            )
    psi = zero_state(circuit.num_qubits, dtype) if psi0 is None else psi0.astype(dtype)

    items = circuit.gates
    if backend == "auto":
        from qkan_implementation.sim.fusion import fuse_register_ops
        from qkan_implementation.sim.ladder import apply_ladder, fuse_ladders

        items = fuse_register_ops(
            fuse_ladders(circuit, min_len=AUTO_LADDER_MIN), circuit.num_qubits
        )
    for gate in items:
        if not isinstance(gate, Gate):  # a fused pseudo-op
            from qkan_implementation.sim.fusion import (
                BitPermutation,
                HRegister,
                apply_bit_permutation,
                apply_h_register,
            )

            if isinstance(gate, HRegister):
                psi = apply_h_register(psi, gate, circuit.num_qubits)
            elif isinstance(gate, BitPermutation):
                psi = apply_bit_permutation(psi, gate, circuit.num_qubits)
            else:  # a scan-fused LadderSegment
                psi = apply_ladder(psi, gate, circuit.num_qubits)
        else:
            psi = apply_gate(psi, gate, circuit.num_qubits)
    return psi


def unitary(circuit: Circuit, dtype=None) -> jax.Array:
    """Dense unitary of ``circuit``: vmap of ``simulate`` over identity columns.

    Replaces Aer's ``unitary_simulator`` path
    (reference ``MulStep.py:120-122``).  U[:, j] = circuit |j>.
    """
    dtype = dtype or default_dtype(circuit)
    dim = 2**circuit.num_qubits
    eye = jnp.eye(dim, dtype=dtype)
    cols = jax.vmap(lambda col: simulate(circuit, col, dtype))(eye)
    return cols.T  # row i of cols is U|i>, i.e. column i of U


def compile_simulator(circuit: Circuit, dtype=None):
    """Return a jitted ``psi0 -> psi_final`` function for repeated use."""
    dtype = dtype or default_dtype(circuit)
    return jax.jit(partial(simulate, circuit, dtype=dtype))
