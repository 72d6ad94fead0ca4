"""Quantum-verified QKAN forward: the layer computed *through* the simulator.

The reference's quantum path is forward-only and test-only: FABLE circuits
are built per step and checked against Aer (``QKAN_Steps_original/*`` test
classes).  Here the whole path is a first-class, differentiable computation:
the FABLE rotation angles are traced jnp values, the statevector engine
consumes them, and gradients flow through ``arccos`` -> gate application ->
amplitude extraction (BASELINE.json north star: "differentiable through the
simulator").
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from qkan_implementation.ops.qkan_layer import lcu_combine_diag, sum_step
from qkan_implementation.sim.circuit import Circuit
from qkan_implementation.sim.statevector import simulate


def _next_pow2_exp(n: int) -> int:
    return max(1, int(np.ceil(np.log2(max(n, 1)))))


def fable_diag_traced(diag: jax.Array):
    """FABLE block encoding of a diagonal matrix with *traced* angles.

    ``diag``: length-2^n vector (jnp, may be a tracer).  Returns
    (circuit, alpha) where the circuit's ucry parameters are jnp values, so
    the whole simulation is differentiable w.r.t. ``diag``.  The |a| <= 1
    subnormalization uses a smooth-safe clip; alpha is returned as a traced
    scalar.
    """
    flat, alpha = _diag_angles(diag)
    n = int(np.log2(diag.shape[-1]))
    circ = _build_diag_circuit(n, flat)
    return circ, alpha


def _diag_angles(diag: jax.Array):
    """Traced FABLE-diagonal rotation angles: (flat [size^2] thetas,
    alpha).  The differentiable half of ``fable_diag_traced``."""
    size = diag.shape[-1]
    n = int(np.log2(size))
    if 2**n != size:
        raise ValueError("diag length must be a power of two")

    # Dtype-aware subnormalization margin: it must survive rounding in the
    # working precision, or max|diag| >= 1 makes scaled hit exactly +/-1 and
    # d(arccos)/dx = -inf poisons every gradient with NaN (observed in f32,
    # where (1 + 1e-8) rounds to exactly 1.0).  32*eps keeps arccos' slope
    # finite (~|1/sqrt(2*margin)|) at negligible encoding error.
    margin = 32.0 * float(jnp.finfo(jnp.asarray(diag).dtype).eps)
    alpha = jnp.maximum(1.0, jnp.max(jnp.abs(diag)) * (1.0 + margin))
    scaled = diag / alpha

    # Row-major flat index of diagonal entries: i*size + i; off-diagonal
    # entries are zero -> theta = pi (constant).
    flat = jnp.full((size * size,), jnp.pi, dtype=scaled.dtype)
    idx = jnp.arange(size) * size + jnp.arange(size)
    clip_lim = 1.0 - margin
    thetas = 2.0 * jnp.arccos(jnp.clip(scaled, -clip_lim, clip_lim))
    flat = flat.at[idx].set(thetas)
    return flat, alpha


def _build_diag_circuit(n: int, ucry_params) -> Circuit:
    """The FABLE-diagonal circuit structure for a 2^n diagonal."""
    circ = Circuit(2 * n + 1)
    anc = 2 * n
    for qubit in range(n, 2 * n):
        circ.h(qubit)
    circ.ucry(ucry_params, tuple(range(2 * n - 1, -1, -1)), anc)
    for j in range(n):
        circ.swap(j, n + j)
    for qubit in range(n, 2 * n):
        circ.h(qubit)
    return circ


@lru_cache(maxsize=16)
def _diag_circuit_template(n: int):
    """Structure-only FABLE-diagonal circuit (placeholder ucry angles),
    cached per size with its ucry gate index.

    The sharded engine's compiled-executor cache hangs on the Circuit
    OBJECT (review r3): a fresh circuit per call attached a fresh cache
    and re-traced + re-compiled the shard_map executor every eager call
    -- the compile the cache exists to eliminate.  The traced angles ride in as ``runtime_params``, so the
    structure is the only thing worth keying."""
    size = 2**n
    circ = _build_diag_circuit(
        n, np.full((size * size,), np.pi, dtype=np.float32)
    )
    (ucry_idx,) = [i for i, g in enumerate(circ.gates) if g.name == "ucry"]
    return circ, ucry_idx


def quantum_extract_diag(diag: jax.Array) -> jax.Array:
    """Round-trip a diagonal through its block encoding on the simulator.

    Returns the diagonal as recovered from circuit amplitudes:
    out[j] = <j| U |j> * alpha * 2^n.  Numerically equal to ``diag`` (to
    simulation precision) but computed through the full quantum pipeline --
    and differentiable w.r.t. ``diag``.
    """
    size = diag.shape[-1]
    n = int(np.log2(size))
    circ, alpha = fable_diag_traced(diag)
    dim = 2 ** (2 * n + 1)

    basis = jnp.eye(size, dim, dtype=diag.dtype)  # e_j over the full space

    def one_column(e):
        psi = simulate(circ, psi0=e, dtype=diag.dtype)
        return psi

    columns = jax.vmap(one_column)(basis)  # [size, dim]
    amps = jnp.take_along_axis(
        columns, jnp.arange(size)[:, None], axis=1
    ).squeeze(-1)
    return amps * alpha * size


def quantum_extract_diag_packed(diag: jax.Array) -> jax.Array:
    """Diagonal extraction from ONE simulation over a packed identity block.

    ``quantum_extract_diag`` runs 2^n simulations (one per basis column).
    For a *diagonal* encoded matrix the off-diagonal elements of the
    block are exactly zero, so the uniform superposition over the 2^n
    column states recovers every diagonal entry simultaneously:

        U |0_anc, 0_row> (1/sqrt(size)) sum_c |c>
          -> amp[j] = diag[j] / (alpha * size * sqrt(size))   at |0, 0, j>

    One 2^(2n+1)-amplitude simulation instead of 2^n of them -- the
    factor-2^n cost reduction that makes the quantum-differentiable layer
    usable at N=K=16 (VERDICT r1 item 2).  Differentiable w.r.t. ``diag``.
    """
    size = diag.shape[-1]
    n = int(np.log2(size))
    circ, alpha = fable_diag_traced(diag)
    dim = 2 ** (2 * n + 1)
    psi0 = (
        jnp.zeros(dim, dtype=diag.dtype)
        .at[:size]
        .set(1.0 / np.sqrt(size))
    )
    psi = simulate(circ, psi0=psi0, dtype=diag.dtype)
    return psi[:size] * (alpha * size * np.sqrt(size))


def quantum_extract_diag_packed_sharded(
    diag: jax.Array, mesh, exchange_impl: str = "collective"
) -> jax.Array:
    """Packed diagonal extraction on the MESH-SHARDED statevector engine.

    Identical math to ``quantum_extract_diag_packed``, but the
    2^(2n+1)-amplitude simulation shards over ``mesh`` (``sim.sharded``),
    so quantum-mode layers whose block encoding exceeds one device's HBM
    still run -- the scaling mode for N*K past ~2^12 (a 25-qubit circuit is
    128 MB/sample at f32; 8 devices hold it at 16 MB each).  The traced
    rotation angles ride into ``shard_map`` as runtime operands
    (``sharded_simulate(runtime_params=...)``), keeping the whole path
    differentiable w.r.t. ``diag``.
    """
    from jax.sharding import NamedSharding, PartitionSpec
    from qkan_implementation.sim.sharded import sharded_simulate

    size = diag.shape[-1]
    n = int(np.log2(size))
    # per-size circuit TEMPLATE + traced angles as runtime operands: the
    # compiled-executor cache hangs on the circuit object, so reusing one
    # template makes repeat eager calls hit the cache instead of paying a
    # fresh shard_map trace + compile every time
    flat, alpha = _diag_angles(diag)
    circ, ucry_idx = _diag_circuit_template(n)
    dim = 2 ** (2 * n + 1)
    # Build the packed initial state SHARDED: with out_shardings set, each
    # device materializes only its 2^q/n_dev slice -- never the full state
    # on one device (that dense spike is exactly what this mode avoids).
    psi0 = jax.jit(
        lambda: jnp.zeros(dim, dtype=diag.dtype)
        .at[:size]
        .set(1.0 / np.sqrt(size)),
        out_shardings=NamedSharding(mesh, PartitionSpec(mesh.axis_names[0])),
    )()
    psi = sharded_simulate(
        circ,
        mesh,
        psi0=psi0,
        dtype=diag.dtype,
        exchange_impl=exchange_impl,
        runtime_params={ucry_idx: flat},
    )
    return psi[:size] * (alpha * size * np.sqrt(size))


def _pad_pow2(v: jax.Array) -> jax.Array:
    """Zero-pad a vector up to the next power-of-two length (identity when
    already a power of two) -- the shared pre-encoding convention for every
    quantum-mode entry point."""
    size = v.shape[-1]
    padded_size = 2 ** _next_pow2_exp(size)
    if padded_size == size:
        return v
    return jnp.concatenate(
        [v, jnp.zeros(padded_size - size, dtype=v.dtype)]
    )


def qkan_layer_forward_quantum_sharded(
    x: jax.Array, weights: jax.Array, N: int, K: int, mesh,
    exchange_impl: str = "collective",
) -> jax.Array:
    """Quantum-mode layer forward with the block encoding sharded over a
    device mesh -- ``qkan_layer_forward_quantum`` past single-device HBM.
    Differentiable end-to-end (gradients flow through arccos -> sharded
    gate application -> amplitude extraction, with the shard_map operand
    path psumming the angle cotangents).

    ``exchange_impl`` picks the collective behind the qubit exchanges
    ('collective' or 'all_to_all', see ``sim.sharded.sharded_simulate``)."""
    lcu = _pad_pow2(lcu_combine_diag(x, weights, K))
    size = N * K
    recovered = quantum_extract_diag_packed_sharded(
        lcu, mesh, exchange_impl=exchange_impl
    )[:size]
    return sum_step(recovered, N, K)


def qkan_layer_forward_quantum(
    x: jax.Array, weights: jax.Array, N: int, K: int, packed: bool = True
) -> jax.Array:
    """QKAN layer forward computed through the block-encoding simulator.

    Equivalent to ``qkan_layer_forward`` but the LCU diagonal physically
    round-trips through its FABLE circuit before the SUM step -- the
    "quantum mode" of the layer.  Differentiable end-to-end.

    ``packed=True`` (default) extracts the diagonal from one packed
    simulation (see ``quantum_extract_diag_packed``); ``False`` runs the
    strict per-basis-column extraction (2^n simulations) used by the
    verification tests.
    """
    lcu = _pad_pow2(lcu_combine_diag(x, weights, K))
    size = N * K
    extract = quantum_extract_diag_packed if packed else quantum_extract_diag
    recovered = extract(lcu)[:size]
    return sum_step(recovered, N, K)


def qkan_layer_forward_quantum_batched(
    x: jax.Array, weights: jax.Array, N: int, K: int
) -> jax.Array:
    """Batched quantum-mode forward: [B, N] -> [B, K], vmapped over samples.

    Each sample's LCU diagonal rides its own packed block-encoding
    simulation; the whole batch is one XLA computation (gradient training
    through the simulator at N=K=16 runs in seconds)."""
    return jax.vmap(
        lambda xi: qkan_layer_forward_quantum(xi, weights, N, K, packed=True)
    )(x)


def quantum_extract_block_columns(
    a: np.ndarray, num_rows: int | None = None, chunk: int = 64,
    return_encoding: bool = False,
):
    """Recover a FABLE-encoded matrix from its circuit, column by column.

    Simulates U|e_c> for exactly the columns of ``a`` (chunked vmap) and
    reads the top block -- O(cols * 2^(2m+1)) work instead of the full
    O(4^(2m+1)) ``unitary()`` construction the round-1 quantum mode used
    (VERDICT r1 item 2: "stop encoding the [B,F] design matrix" cost).
    Returns the recovered matrix with ``a``'s shape (or ``num_rows`` rows);
    with ``return_encoding=True`` returns ``(recovered, circuit, alpha)``
    so resource accounting reuses the circuit that was actually simulated
    instead of re-encoding (the arccos + gate emission is the expensive
    part for large design matrices).
    """
    from qkan_implementation.encoding.fable import fable

    a = np.asarray(a)
    rows = num_rows if num_rows is not None else a.shape[0]
    cols = a.shape[1]
    circuit, alpha = fable(a)
    dim = 2**circuit.num_qubits
    block = 2 ** ((circuit.num_qubits - 1) // 2)

    sim = jax.jit(jax.vmap(lambda e: simulate(circuit, psi0=e)[:block]))
    # float output regardless of a's dtype: the recovered amplitudes are
    # real-valued, and an integer buffer would silently truncate them
    out = np.empty((rows, cols), dtype=np.promote_types(a.dtype, np.float32))
    for start in range(0, cols, chunk):
        end = min(start + chunk, cols)
        basis = np.zeros((chunk, dim))  # fixed shape: one compile per chunk size
        basis[np.arange(end - start), np.arange(start, end)] = 1.0
        amps = np.asarray(sim(jnp.asarray(basis)))
        out[:, start:end] = (amps[: end - start, :rows].T * alpha * block).real
    if return_encoding:
        return out, circuit, alpha
    return out


def quantum_verify_pipeline(
    x: jax.Array, weights: jax.Array, N: int, K: int
) -> dict:
    """Per-stage block-encoding round-trip errors (the library counterpart
    of the reference's step-test verification, MulStep.py:115-166).

    Returns relative errors for each pipeline stage; all should sit at
    simulation precision.
    """
    from qkan_implementation.ops.chebyshev import dilated_chebyshev_diag
    from qkan_implementation.ops.qkan_layer import weighted_chebyshev_diag

    max_degree = weights.shape[0] - 1
    errors = {}

    def diag_error(diag):
        size = diag.shape[-1]
        rec = quantum_extract_diag(_pad_pow2(diag))[:size]
        denom = jnp.linalg.norm(diag)
        return jnp.where(
            denom > 1e-30, jnp.linalg.norm(rec - diag) / denom, jnp.linalg.norm(rec)
        )

    for d in range(max_degree + 1):
        cheb = dilated_chebyshev_diag(x, K, d)
        errors[f"cheb_deg{d}"] = float(diag_error(cheb))
        errors[f"mul_deg{d}"] = float(
            diag_error(weighted_chebyshev_diag(x, weights[d], K, d))
        )
    lcu = lcu_combine_diag(x, weights, K)
    errors["lcu"] = float(diag_error(lcu))
    summed = sum_step(lcu, N, K)
    exp = _next_pow2_exp(K)
    padded = 2**exp
    s = summed
    if padded != K:
        s = jnp.concatenate([s, jnp.zeros(padded - K, dtype=s.dtype)])
    errors["sum"] = float(diag_error(s))
    return errors
