"""Qubit exchanges of the sharded statevector engine vs the dense engine.

Both exchange primitives -- the pairwise ``ppermute`` ('collective') and the
grouped ``all_to_all`` -- are what the engine hands to NCCL across GPUs.
Here they run on the 8-virtual-device CPU mesh against the dense engine and
a NumPy bit-permutation reference.  Physics contract: identical to the dense
engine (reference semantics ``QKAN_Steps_original/MulStep.py:115-166``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from qkan_implementation.parallel import make_mesh
from qkan_implementation.parallel.collectives import (
    pairwise_exchange,
    pairwise_exchange_a2a,
)
from qkan_implementation.sim import Circuit, simulate
from qkan_implementation.sim.sharded import (
    _exchange_global_local,
    sharded_simulate,
)

AXIS = "d"
NDEV = 8
IMPLS = ("collective", "all_to_all")
PAIRWISE = {"collective": pairwise_exchange, "all_to_all": pairwise_exchange_a2a}


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8, axis_name=AXIS)


def _swap_bits(state, a, b):
    """Reference: the state with index bits a and b exchanged."""
    idx = np.arange(state.size)
    bit_a, bit_b = (idx >> a) & 1, (idx >> b) & 1
    src = idx & ~((1 << a) | (1 << b)) | (bit_a << b) | (bit_b << a)
    return state[src]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dev_bit,chunks", [(0, 1), (1, 4), (2, 8)])
def test_exchange_then_rotation_matches_dense(mesh8, impl, dev_bit, chunks):
    """Exchange a global qubit with the local MSB, then rotate it: the
    sharded two-step equals the same bit swap + rotation on the full
    state."""
    q_local = 11
    m = 2 ** (q_local - 1)
    rng = np.random.default_rng(q_local * 10 + dev_bit)
    full = rng.standard_normal(NDEV * 2 * m)
    thetas = rng.standard_normal(NDEV * m)
    xs = jax.device_put(jnp.asarray(full), NamedSharding(mesh8, P(AXIS)))
    th = jax.device_put(jnp.asarray(thetas), NamedSharding(mesh8, P(AXIS)))

    def two_step(block, t):
        psi = _exchange_global_local(
            block, dev_bit, q_local - 1, AXIS, NDEV, chunks,
            pairwise_fn=PAIRWISE[impl],
        )
        v = psi.reshape(2, m)
        c, s = jnp.cos(t / 2), jnp.sin(t / 2)
        return jnp.stack([c * v[0] - s * v[1], s * v[0] + c * v[1]]).reshape(-1)

    got = np.asarray(jax.jit(jax.shard_map(
        two_step, mesh=mesh8, in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS),
    ))(xs, th))

    swapped = _swap_bits(full, q_local + dev_bit, q_local - 1)
    want = np.empty_like(swapped)
    c, s = np.cos(thetas / 2), np.sin(thetas / 2)
    for d in range(NDEV):
        v = swapped[d * 2 * m:(d + 1) * 2 * m].reshape(2, m)
        t = slice(d * m, (d + 1) * m)
        want[d * 2 * m:(d + 1) * 2 * m] = np.concatenate(
            [c[t] * v[0] - s[t] * v[1], s[t] * v[0] + c[t] * v[1]]
        )
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("chunks", [1, 4])
def test_fable_circuit_matches_dense(mesh8, impl, chunks):
    """Full FABLE block encoding: the fused ucry targets the top (global)
    qubit, so the exchange carries the whole encoding's communication."""
    from qkan_implementation.encoding.fable import fable

    rng = np.random.default_rng(7)
    a = rng.standard_normal((128, 128))
    a /= np.max(np.abs(a))
    circ, _ = fable(a)
    assert circ.num_qubits == 15  # q_local = 12 on 8 devices
    dense = np.asarray(simulate(circ))
    shard = np.asarray(jax.device_get(sharded_simulate(
        circ, mesh8, exchange_impl=impl, exchange_chunks=chunks,
    )))
    np.testing.assert_allclose(shard, dense, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
def test_partial_control_register_matches_dense(mesh8, impl):
    """Global-target ucry gates with scattered local controls and with a
    control that became global after an earlier exchange evicted it."""
    q = 14  # q_local = 11 on the 8-device mesh
    rng = np.random.default_rng(17)
    circ = Circuit(q)
    circ.h(2).h(5)
    circ.ucry(rng.uniform(-np.pi, np.pi, 8), controls=(7, 2, 4), target=q - 1)
    circ.h(0)
    circ.ucry(rng.uniform(-np.pi, np.pi, 4), controls=(10, 3), target=q - 2)
    dense = np.asarray(simulate(circ))
    shard = np.asarray(jax.device_get(
        sharded_simulate(circ, mesh8, exchange_impl=impl)
    ))
    np.testing.assert_allclose(shard, dense, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
def test_global_h_walls_match_dense(mesh8, impl):
    """A lone global Hadamard, and a wall mixing a global qubit, the local
    MSB and another local qubit."""
    q = 14
    rng = np.random.default_rng(23)
    circ = Circuit(q)
    circ.h(q - 1)
    circ.ucry(rng.uniform(-np.pi, np.pi, 2), controls=(0,), target=1)
    circ.h(q - 2).h(10).h(2)
    circ.ucry(rng.uniform(-np.pi, np.pi, 4), controls=(3, 5), target=q - 1)
    dense = np.asarray(simulate(circ))
    shard = np.asarray(jax.device_get(
        sharded_simulate(circ, mesh8, exchange_impl=impl)
    ))
    np.testing.assert_allclose(shard, dense, atol=1e-12)


@pytest.mark.parametrize("impl", IMPLS)
def test_state_gradient_matches_dense(mesh8, impl):
    """d(loss)/d(psi0) through the exchanges equals the dense engine's."""
    q = 14
    rng = np.random.default_rng(29)
    circ = Circuit(q)
    circ.h(q - 1).h(4)
    circ.ucry(rng.uniform(-np.pi, np.pi, 2), controls=(1,), target=0)
    circ.h(q - 2)
    psi0 = jnp.asarray(rng.standard_normal(2**q))
    psi0 = psi0 / jnp.linalg.norm(psi0)
    g_shard = jax.grad(lambda p: jnp.sum(sharded_simulate(
        circ, mesh8, psi0=p, dtype=p.dtype, exchange_impl=impl
    ) ** 3))(psi0)
    g_dense = jax.grad(lambda p: jnp.sum(simulate(circ, psi0=p) ** 3))(psi0)
    np.testing.assert_allclose(
        np.asarray(g_shard), np.asarray(g_dense), atol=1e-10
    )


@pytest.mark.parametrize("impl", IMPLS)
def test_quantum_extraction_gradient_matches_dense(mesh8, impl):
    """Quantum-mode packed diagonal extraction on the sharded engine: the
    weight gradient equals the dense extraction's."""
    from qkan_implementation.ops.quantum import (
        quantum_extract_diag_packed,
        quantum_extract_diag_packed_sharded,
    )

    rng = np.random.default_rng(5)
    diag = jnp.asarray(rng.uniform(-0.9, 0.9, 128))  # 15-qubit circuit
    g_shard = jax.grad(lambda d: jnp.sum(quantum_extract_diag_packed_sharded(
        d, mesh8, exchange_impl=impl
    ) ** 3))(diag)
    g_dense = jax.grad(
        lambda d: jnp.sum(quantum_extract_diag_packed(d) ** 3)
    )(diag)
    np.testing.assert_allclose(
        np.asarray(g_shard), np.asarray(g_dense), atol=1e-9
    )


def test_unknown_exchange_impl_raises(mesh8):
    circ = Circuit(4)
    circ.h(3)
    with pytest.raises(ValueError, match="exchange_impl"):
        sharded_simulate(circ, mesh8, exchange_impl="rdma")
