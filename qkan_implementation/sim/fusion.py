"""Register-level gate fusion for the dense statevector engine.

FABLE circuits (encoding.fable) are layered: an H wall on the row register
(n gates), the fused ucry, a register swap (n swap gates), and a second H
wall.  Executed gate-by-gate that is 3n+1 full-state HBM passes; fused it
is THREE: one Walsh-Hadamard contraction per H wall (a matmul over a 2^k
register axis) and one static-gather bit permutation for the swap run.

Pseudo-ops produced by ``fuse_register_ops``:

- ``HRegister(qubits)``: H on every listed qubit, applied per contiguous
  qubit segment as a [outer, 2^k, inner] x [2^k, 2^k] tensordot.
- ``BitPermutation(perm)``: amplitude index remap new_bit[i] = old_bit
  perm[i], applied as one gather with a statically precomputed index.

Reference semantics unchanged: the pass is an executor optimization; tests
pin fused-vs-unfused equality on random and FABLE circuits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qkan_implementation.sim.circuit import Circuit, Gate


@dataclass(frozen=True)
class HRegister:
    qubits: Tuple[int, ...]  # sorted ascending, distinct


@dataclass(frozen=True)
class BitPermutation:
    # perm[new_position] = old_position (bit sources per destination bit)
    perm: Tuple[int, ...]


def _compose_swap(perm: list, a: int, b: int) -> None:
    perm[a], perm[b] = perm[b], perm[a]


def fuse_register_ops(gates, num_qubits: int, min_h: int = 2, min_swaps: int = 2):
    """Rewrite maximal H-walls and swap-runs into register pseudo-ops.

    Runs shorter than the thresholds stay as plain gates (a lone H is
    cheaper unfused).
    """
    items = []
    i = 0
    n = len(gates)
    while i < n:
        g = gates[i]
        if isinstance(g, Gate) and g.name == "h":
            qs = []
            j = i
            while (
                j < n
                and isinstance(gates[j], Gate)
                and gates[j].name == "h"
                and gates[j].qubits[0] not in qs
            ):
                qs.append(gates[j].qubits[0])
                j += 1
            if len(qs) >= min_h:
                items.append(HRegister(tuple(sorted(qs))))
                i = j
                continue
        if isinstance(g, Gate) and g.name == "swap":
            perm = list(range(num_qubits))
            j = i
            while j < n and isinstance(gates[j], Gate) and gates[j].name == "swap":
                _compose_swap(perm, gates[j].qubits[0], gates[j].qubits[1])
                j += 1
            if j - i >= min_swaps:
                items.append(BitPermutation(tuple(perm)))
                i = j
                continue
        items.append(g)
        i += 1
    return items


def _contiguous_segments(qubits: Tuple[int, ...]):
    segs = []
    start = prev = qubits[0]
    for q in qubits[1:]:
        if q == prev + 1:
            prev = q
            continue
        segs.append((start, prev))
        start = prev = q
    segs.append((start, prev))
    return segs


def _hadamard_matrix(k: int) -> np.ndarray:
    h = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
    m = np.array([[1.0]])
    for _ in range(k):
        m = np.kron(m, h)
    return m


def apply_h_register(psi: jax.Array, op: HRegister, num_qubits: int) -> jax.Array:
    """One tensordot per contiguous qubit segment (capped at 2^10 blocks:
    larger registers split so the transform matrix stays small)."""
    shape = psi.shape
    for lo, hi in _contiguous_segments(op.qubits):
        while lo <= hi:
            k = min(hi - lo + 1, 10)
            inner = 2**lo
            block = 2**k
            outer = psi.size // (inner * block)
            v = psi.reshape(outer, block, inner)
            m = jnp.asarray(_hadamard_matrix(k), dtype=psi.dtype)
            # HIGHEST: f32 matmuls may run in TF32 by default (see
            # statevector._apply_dense)
            psi = jnp.einsum(
                "ab,obi->oai", m, v, precision=jax.lax.Precision.HIGHEST
            ).reshape(-1)
            lo += k
    return psi.reshape(shape)


def _permutation_blocks(perm: Tuple[int, ...]):
    """Contiguous runs of the bit map: [(old_start, new_start, length)]."""
    blocks = []
    i = 0
    q = len(perm)
    while i < q:
        start = perm[i]
        length = 1
        while i + length < q and perm[i + length] == start + length:
            length += 1
        blocks.append((start, i, length))
        i += length
    return blocks


def apply_bit_permutation(
    psi: jax.Array, op: BitPermutation, num_qubits: int
) -> jax.Array:
    """Amplitude remap out[idx] bit i = psi[...] bit op.perm[i].

    Few-block permutations (register swaps: 3 blocks) lower to a low-rank
    reshape + transpose, which XLA tiles at near memory bandwidth; a
    gather on random-looking indices is slower.  Many-block permutations fall back to one gather with device-side
    iota index math (a host index constant would embed 2^q * 8 B into the
    program -- 268 MB at 25 qubits)."""
    blocks = _permutation_blocks(op.perm)
    if len(blocks) <= 10:
        # view axes major->minor = source blocks by descending old_start
        src_order = sorted(blocks, key=lambda b: -b[0])
        shape = [2 ** b[2] for b in src_order]
        axis_of_block = {b: i for i, b in enumerate(src_order)}
        # output axes major->minor = blocks by descending new_start
        dst_order = sorted(blocks, key=lambda b: -b[1])
        axes = [axis_of_block[b] for b in dst_order]
        return (
            psi.reshape(shape).transpose(axes).reshape(psi.shape)
        )
    idx = jnp.arange(psi.size, dtype=jnp.int32 if psi.size < 2**31 else jnp.int64)
    moved = [(n, o) for n, o in enumerate(op.perm) if n != o]
    src = idx
    for new_pos, old_pos in moved:
        src = src & ~(1 << old_pos)  # clear the destination bit
    for new_pos, old_pos in moved:
        src = src | (((idx >> new_pos) & 1) << old_pos)
    return psi.reshape(-1)[src].reshape(psi.shape)


def simulate_fable_runtime(
    cos_half: jax.Array,
    sin_half: jax.Array,
    n: int,
    psi0: jax.Array | None = None,
) -> jax.Array:
    """Fused FABLE block-encoding simulation with RUNTIME rotation params.

    The fused circuit is exactly: H wall on the row register, one MSB
    multiplexed Ry, the register-swap permutation, H wall again -- so it
    executes here directly from (cos_half, sin_half) arrays produced by
    ``encoding.fable_runtime_params``, with the rotation parameters as
    traced arguments instead of program constants (a circuit that carries
    4^n angles as constants makes one compile per matrix, and large
    constants slow compilation).  Differentiable w.r.t. cos_half/sin_half and psi0.
    """
    q = 2 * n + 1
    m = cos_half.shape[0]
    if m != 4**n:
        raise ValueError(f"expected 4^{n} parameters, got {m}")
    if psi0 is None:
        from qkan_implementation.sim.statevector import zero_state

        psi = zero_state(q, cos_half.dtype)
    else:
        psi = psi0
    hreg = HRegister(tuple(range(n, 2 * n)))
    perm = BitPermutation(
        tuple(list(range(n, 2 * n)) + list(range(n)) + [2 * n])
    )

    psi = apply_h_register(psi, hreg, q)
    v = psi.reshape(2, m)
    c = cos_half.astype(psi.dtype)
    s = sin_half.astype(psi.dtype)
    psi = jnp.concatenate([c * v[0] - s * v[1], s * v[0] + c * v[1]])
    psi = apply_bit_permutation(psi, perm, q)
    return apply_h_register(psi, hreg, q)
