"""Scan-fused execution of Ry/CNOT ladders (FABLE's elementary form).

An elementary FABLE circuit contains 2*4^n alternating Ry/CNOT gates on a
single rotation target.  Unrolled tracing makes XLA graphs (and compile
time) linear in gate count; here a maximal ladder run compiles to ONE
``lax.scan`` whose step applies an Ry with a traced angle and a CNOT with a
*traced control index* (bit arithmetic on a static iota), so compile time
is O(1) in ladder length while execution stays a fused elementwise update.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from qkan_implementation.sim.circuit import Circuit, Gate


@dataclass
class LadderSegment:
    """A run of Ry/CNOT gates sharing one target qubit, encoded as arrays.

    Step i applies Ry(thetas[i]) on ``target`` then, if ctrls[i] >= 0,
    CNOT(ctrls[i], target).
    """

    target: int
    thetas: np.ndarray  # [L]
    ctrls: np.ndarray  # [L], -1 = no CNOT this step


def _static_theta(gate) -> float | None:
    """The gate's angle as a concrete float, or None if it is traced."""
    p = gate.params[0] if isinstance(gate.params, (tuple, list)) else gate.params
    if hasattr(p, "aval"):  # any traced jax value
        return None
    try:
        return float(np.asarray(p).reshape(-1)[0])
    except (TypeError, jax.errors.TracerArrayConversionError):
        return None


def fuse_ladders(circuit: Circuit, min_len: int = 8):
    """Split the gate list into LadderSegments and passthrough gates.

    A ladder is a maximal run of ``ry(target)`` / ``cx(*, target)`` gates on
    a common target; runs shorter than ``min_len`` stay as plain gates.
    Gates with traced (non-concrete) angles break a run -- segments need
    static angle arrays.
    """
    items = []
    i = 0
    gates = circuit.gates
    while i < len(gates):
        g = gates[i]
        target = None
        if g.name == "ry" and _static_theta(g) is not None:
            target = g.qubits[0]
        elif g.name == "cx":
            target = g.qubits[1]
        if target is not None:
            j = i
            steps = []  # (theta, ctrl)
            pending_theta = None
            while j < len(gates):
                gj = gates[j]
                if gj.name == "ry" and gj.qubits[0] == target:
                    theta = _static_theta(gj)
                    if theta is None:
                        break
                    if pending_theta is not None:
                        steps.append((pending_theta, -1))
                    pending_theta = theta
                elif gj.name == "cx" and gj.qubits[1] == target:
                    steps.append(
                        (pending_theta if pending_theta is not None else 0.0,
                         gj.qubits[0])
                    )
                    pending_theta = None
                else:
                    break
                j += 1
            if pending_theta is not None:
                steps.append((pending_theta, -1))
            if len(steps) >= min_len:
                items.append(
                    LadderSegment(
                        target=target,
                        thetas=np.array([s[0] for s in steps]),
                        ctrls=np.array([s[1] for s in steps], dtype=np.int32),
                    )
                )
                i = j
                continue
        items.append(g)
        i += 1
    return items


def apply_ladder(psi: jax.Array, seg: LadderSegment, num_qubits: int) -> jax.Array:
    """One lax.scan over the ladder steps."""
    t = seg.target
    inner = 2**t
    dim = psi.shape[0]
    idx = jnp.arange(dim, dtype=jnp.int32)

    thetas = jnp.asarray(seg.thetas, dtype=psi.dtype)
    ctrls = jnp.asarray(seg.ctrls)

    def step(psi, tc):
        theta, c = tc
        v = psi.reshape(-1, 2, inner)
        p0 = v[:, 0, :]
        p1 = v[:, 1, :]
        co = jnp.cos(theta / 2.0)
        si = jnp.sin(theta / 2.0)
        v = jnp.stack([co * p0 - si * p1, si * p0 + co * p1], axis=1)
        psi = v.reshape(-1)
        # CNOT(c, t) with traced c: flip the target bit where bit c is set
        flipped = v[:, ::-1, :].reshape(-1)
        shift = jnp.maximum(c, 0)
        take_flipped = (c >= 0) & (((idx >> shift) & 1) == 1)
        return jnp.where(take_flipped, flipped, psi), None

    psi, _ = jax.lax.scan(step, psi, (thetas, ctrls))
    return psi


def simulate_fused(
    circuit: Circuit,
    psi0: jax.Array | None = None,
    dtype=None,
    min_len: int = 8,
) -> jax.Array:
    """Like ``statevector.simulate`` but with ladder runs scan-fused --
    constant compile time in ladder length (use for elementary FABLE
    circuits at larger n)."""
    from qkan_implementation.sim.statevector import (
        apply_gate,
        default_dtype,
        zero_state,
    )

    dtype = dtype or default_dtype(circuit)
    psi = (
        zero_state(circuit.num_qubits, dtype)
        if psi0 is None
        else psi0.astype(dtype)
    )
    for item in fuse_ladders(circuit, min_len=min_len):
        if isinstance(item, LadderSegment):
            psi = apply_ladder(psi, item, circuit.num_qubits)
        else:
            psi = apply_gate(psi, item, circuit.num_qubits)
    return psi
