"""Sharded statevector vs dense engine on the virtual 8-device CPU mesh.

The multi-chip contract (SURVEY.md sections 2, 5): gates on global (sharded)
qubits must produce bit-identical physics to the dense simulator, with the
qubit-remapping exchange handling non-diagonal action and device-bit
selection handling diagonal structure.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qkan_implementation.parallel import make_mesh
from qkan_implementation.sim import Circuit, simulate
from qkan_implementation.sim.sharded import sharded_simulate


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8, axis_name="d")


def assert_matches_dense(circ, mesh, psi0=None, atol=1e-10):
    dense = np.asarray(simulate(circ, psi0=psi0))
    shard = np.asarray(jax.device_get(sharded_simulate(circ, mesh, psi0=psi0)))
    np.testing.assert_allclose(shard, dense, atol=atol)


def test_local_gates_only(mesh8):
    circ = Circuit(6).h(0).ry(0.3, 1).cx(0, 2).swap(1, 2)
    assert_matches_dense(circ, mesh8)


def test_h_on_global_qubits(mesh8):
    # qubits 3,4,5 are global on an 8-device mesh of a 6-qubit state
    circ = Circuit(6).h(3).h(4).h(5)
    assert_matches_dense(circ, mesh8)


def test_cx_across_global_local_boundary(mesh8):
    circ = Circuit(6).h(5).cx(5, 0).cx(1, 4)
    assert_matches_dense(circ, mesh8)


def test_swap_two_global_qubits(mesh8):
    circ = Circuit(6).h(4).swap(4, 5).x(3).swap(3, 4)
    assert_matches_dense(circ, mesh8)


def test_diag_on_global_qubits_no_exchange(mesh8):
    rng = np.random.default_rng(0)
    phases = np.exp(1j * rng.uniform(0, 2 * np.pi, 8))
    circ = Circuit(6)
    circ.h(3).h(4).h(5)
    circ.diagonal(phases, (5, 4, 3))
    assert_matches_dense(circ, mesh8)


def test_ucry_with_global_controls_and_global_target(mesh8):
    rng = np.random.default_rng(1)
    q = 6
    # controls spanning global+local, target global: worst case
    thetas = rng.uniform(-np.pi, np.pi, 8)
    circ = Circuit(q)
    for t in range(q):
        circ.h(t)
    circ.ucry(thetas, controls=(5, 2, 0), target=4)
    assert_matches_dense(circ, mesh8)


def test_random_circuits_match(mesh8):
    rng = np.random.default_rng(2)
    q = 7
    for trial in range(3):
        circ = Circuit(q)
        for _ in range(25):
            kind = rng.integers(0, 6)
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
            elif kind == 4:
                circ.cry(float(rng.uniform(0, np.pi)), c, t)
            else:
                k = int(rng.integers(1, 3))
                controls = tuple(
                    int(x) for x in rng.choice([x for x in range(q) if x != t], k, replace=False)
                )
                circ.ucry(rng.uniform(-np.pi, np.pi, 2**k), controls, t)
        assert_matches_dense(circ, mesh8)


def test_fable_block_encoding_sharded(mesh8):
    # End-to-end: FABLE circuit (fused ucry) on the sharded engine.  Verify
    # the top-left block columns via per-column statevector runs.
    from qkan_implementation.encoding import fable

    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (4, 4))
    circ, alpha = fable(a)  # 5 qubits; 8-dev mesh -> needs >3 qubits: ok
    dim = 2**circ.num_qubits
    cols = []
    for j in range(4):  # only the system columns matter for the block
        e = np.zeros(dim)
        e[j] = 1.0
        psi = np.asarray(
            jax.device_get(sharded_simulate(circ, mesh8, psi0=jnp.asarray(e)))
        )
        cols.append(psi[:4])
    block = np.stack(cols, axis=1) * alpha * 4
    np.testing.assert_allclose(block, a, atol=1e-8)


def test_20_qubit_sharded_run(mesh8):
    # The BASELINE north-star scale: a 20-qubit statevector across the
    # mesh, with ANALYTIC physics checks (norm alone passes for any
    # unitary-preserving bug -- wrong exchange permutations included).
    q = 20
    theta = 0.25
    circ = Circuit(q)
    for t in range(q):
        circ.h(t)
    circ.cx(19, 0).cx(0, 19).ry(theta, 18)
    psi = sharded_simulate(circ, mesh8)
    assert np.all(np.isfinite(np.asarray(psi)))
    total = float(jnp.sum(jnp.abs(psi) ** 2))
    np.testing.assert_allclose(total, 1.0, atol=1e-6)

    # analytic marginals: H makes every qubit P(1)=1/2; the CX pair
    # permutes the uniform state (marginals unchanged); Ry(theta) on the
    # |+> qubit 18 gives P(1) = (1 + sin theta)/2
    from functools import partial

    @partial(jax.jit, static_argnames=("t",))
    def marginal(p, t):
        return jnp.sum(
            (p**2).reshape(-1, 2, 2**t)[:, 1, :]
        )

    for t in (0, 7, 17, 19):
        np.testing.assert_allclose(float(marginal(psi, t)), 0.5, atol=1e-9)
    np.testing.assert_allclose(
        float(marginal(psi, 18)), (1.0 + np.sin(theta)) / 2.0, atol=1e-9
    )


def test_global_heavy_circuit_with_layout_tracking(mesh8):
    # Repeated gates on global qubits exercise the lazy-exchange working set
    # and the final layout restore (incl. global<->global cycles via swaps).
    q = 6
    circ = Circuit(q)
    for _ in range(3):
        circ.h(5).ry(0.3, 4).cx(5, 4).h(3)
    circ.swap(5, 3).swap(4, 5)  # permute global qubits among themselves
    circ.ry(0.2, 5)
    assert_matches_dense(circ, mesh8)


def test_layout_restore_local_permutation(mesh8):
    # A circuit whose exchanges leave locals permuted: dense results must
    # still come back in canonical order.
    q = 6
    circ = Circuit(q)
    circ.h(0).h(1).h(2)
    circ.cx(5, 0).cx(4, 1).cx(3, 2)  # each pulls a global qubit local
    circ.ry(0.7, 5).ry(0.9, 4)
    assert_matches_dense(circ, mesh8)


def test_exchange_count_working_set():
    from qkan_implementation.sim.sharded import count_exchanges

    q = 6  # 8 devices -> 3 global qubits
    circ = Circuit(q)
    for _ in range(5):
        circ.h(5).ry(0.1, 5)  # repeated work on one global qubit
    # naive exchange-in/exchange-out: 2 per gate = 20 collectives.
    # the layout keeps qubit 5 local after the first exchange: 1 + restore.
    n = count_exchanges(circ, 8)
    assert n <= 3, n

    # FABLE circuit: H-ladder on globals + ucry target global + swaps
    from qkan_implementation.encoding import fable

    fcirc, _ = fable(np.random.default_rng(0).uniform(-1, 1, (4, 4)))
    naive = 2 * sum(
        1 for g in fcirc.gates if any(t >= fcirc.num_qubits - 3 for t in g.qubits)
    )
    assert count_exchanges(fcirc, 8) < naive


def test_exact_amplitudes_15_qubits_random_circuit(mesh8):
    # VERDICT r1 item 1: amplitude-level sharded-vs-dense equality at
    # 14-16 qubits (round 1 proved exactness only to 7).
    rng = np.random.default_rng(15)
    q = 15
    circ = Circuit(q)
    for t in range(q):
        circ.ry(float(rng.uniform(0, np.pi)), t)
    for _ in range(30):
        kind = rng.integers(0, 4)
        t = int(rng.integers(0, q))
        c = int((t + 1 + rng.integers(0, q - 1)) % q)
        if kind == 0:
            circ.h(t)
        elif kind == 1:
            circ.cx(c, t)
        elif kind == 2:
            circ.swap(c, t)
        else:
            circ.cry(float(rng.uniform(0, np.pi)), c, t)
    assert_matches_dense(circ, mesh8, atol=1e-12)


def test_exact_amplitudes_15_qubit_fable_circuit(mesh8):
    # A real FABLE block encoding (n=7: 128x128 matrix -> 15 qubits) through
    # the sharded engine, amplitude-exact vs dense.
    from qkan_implementation.encoding import fable

    rng = np.random.default_rng(16)
    a = np.diag(rng.uniform(-1, 1, 128))
    circ, alpha = fable(a)
    assert circ.num_qubits == 15
    dense = np.asarray(simulate(circ, backend="xla"))
    shard = np.asarray(jax.device_get(sharded_simulate(circ, mesh8)))
    np.testing.assert_allclose(shard, dense, atol=1e-12)
    np.testing.assert_allclose(shard[:128] * alpha * 128, a[:, 0], atol=1e-8)


def test_f32_fable_ucry_inside_shard_map(mesh8):
    # the FABLE multiplexed Ry at float32 inside the shard_map local (the
    # dtype the card runs): amplitude-exact vs the dense engine to f32
    from qkan_implementation.encoding import fable

    rng = np.random.default_rng(17)
    a = np.diag(rng.uniform(-1, 1, 128))
    circ, alpha = fable(a)  # 15 qubits; q_local=12
    dense = np.asarray(simulate(circ, backend="xla", dtype=jnp.float32))
    shard = np.asarray(
        jax.device_get(sharded_simulate(circ, mesh8, dtype=jnp.float32))
    )
    assert shard.dtype == np.float32
    np.testing.assert_allclose(shard, dense, atol=1e-6)


def test_chunked_exchange_matches_single(mesh8):
    # the overlapped-exchange prototype: chunked collective permutes must be
    # a pure implementation detail
    rng = np.random.default_rng(18)
    q = 14
    circ = Circuit(q)
    for t in range(q):
        circ.ry(float(rng.uniform(0, np.pi)), t)
    circ.h(13).cx(13, 0).h(12).cx(12, 1).swap(11, 2)
    one = np.asarray(jax.device_get(sharded_simulate(circ, mesh8)))
    chunked = np.asarray(
        jax.device_get(sharded_simulate(circ, mesh8, exchange_chunks=4))
    )
    np.testing.assert_allclose(chunked, one, atol=1e-13)
    dense = np.asarray(simulate(circ))
    np.testing.assert_allclose(chunked, dense, atol=1e-12)


def test_24_qubit_marginals_and_expectations(mesh8):
    # Scale run (16M amplitudes, f32) with physics checks: per-qubit
    # marginals of a product-plus-CNOT circuit against analytic values.
    q = 24
    rng = np.random.default_rng(19)
    thetas = rng.uniform(0.2, np.pi - 0.2, q)
    circ = Circuit(q)
    for t in range(q):
        circ.ry(float(thetas[t]), t)
    # entangle across the global/local boundary: CNOT(23 -> 0), CNOT(5 -> 22)
    circ.cx(23, 0).cx(5, 22)
    psi = sharded_simulate(circ, mesh8, dtype=jnp.float32)

    p1 = np.sin(thetas / 2.0) ** 2  # pre-CNOT marginals
    expect = p1.copy()
    expect[0] = p1[23] * (1 - p1[0]) + (1 - p1[23]) * p1[0]
    expect[22] = p1[5] * (1 - p1[22]) + (1 - p1[5]) * p1[22]

    from functools import partial

    @partial(jax.jit, static_argnames=("t",))
    def marginal(psi, t):
        probs = (psi.astype(jnp.float32) ** 2).reshape(-1, 2, 2**t)
        return jnp.sum(probs[:, 1, :])

    for t in (0, 5, 11, 22, 23):
        got = float(marginal(psi, t))
        np.testing.assert_allclose(got, expect[t], atol=1e-5)
    # norm preserved at f32
    total = float(jnp.sum(psi.astype(jnp.float32) ** 2))
    np.testing.assert_allclose(total, 1.0, atol=1e-4)


def test_repeated_simulate_reuses_compiled_executor(mesh8):
    """sharded_simulate caches the jitted executor on the circuit: a fresh
    jit per call re-traced and re-compiled every repeated simulate
    (seconds per call at 20+ qubits).  Repeat calls must reuse the
    compiled fn (spied via the cache dict) and return identical results;
    appending a gate must miss the cache."""
    rng = np.random.default_rng(31)
    q = 8
    circ = Circuit(q)
    for t in range(q):
        circ.ry(float(rng.uniform(0, np.pi)), t)
    circ.h(q - 1).cx(q - 1, 0)
    p1 = np.asarray(jax.device_get(sharded_simulate(circ, mesh8)))
    cache = circ._sharded_exec_cache
    assert len(cache) == 1
    p2 = np.asarray(jax.device_get(sharded_simulate(circ, mesh8)))
    assert len(cache) == 1  # same executor reused
    np.testing.assert_array_equal(p1, p2)
    circ.h(0)  # structural change -> new cache entry, correct result
    p3 = np.asarray(jax.device_get(sharded_simulate(circ, mesh8)))
    assert len(cache) == 2
    np.testing.assert_allclose(p3, np.asarray(simulate(circ)), atol=1e-12)


def test_gate_content_change_misses_executor_cache(mesh8):
    """Regression (advisor r2): the executor cache was keyed on circuit
    identity + gate COUNT, so replacing a gate (same length) or swapping a
    gate's params returned stale compiled results.  The key now covers gate
    content; both supported mutations (gate replacement, params-object
    replacement) must produce fresh, dense-exact results.  Writing into a
    params ndarray IN PLACE after a simulate call is explicitly
    unsupported (``_gate_param_digest`` memoizes per params object so
    repeated large-circuit calls stay O(gates), not O(param bytes))."""
    from qkan_implementation.sim.circuit import Gate

    q = 6
    circ = Circuit(q)
    for t in range(q):
        circ.ry(0.3 + 0.1 * t, t)
    circ.h(q - 1)
    p1 = np.asarray(jax.device_get(sharded_simulate(circ, mesh8)))

    # same-length gate replacement
    circ.gates[0] = Gate("ry", (0,), np.asarray([1.234]))
    p2 = np.asarray(jax.device_get(sharded_simulate(circ, mesh8)))
    assert not np.allclose(p1, p2)
    np.testing.assert_allclose(p2, np.asarray(simulate(circ)), atol=1e-12)

    # params-object replacement on an existing gate (the supported pattern)
    params = np.asarray(circ.gates[1].params).copy()
    params[...] = 2.5
    object.__setattr__(circ.gates[1], "params", params)
    p3 = np.asarray(jax.device_get(sharded_simulate(circ, mesh8)))
    assert not np.allclose(p2, p3)
    np.testing.assert_allclose(p3, np.asarray(simulate(circ)), atol=1e-12)


def test_all_to_all_exchange_impl_matches_dense(mesh8):
    """The swappable comm surface, actually swapped: exchange_impl=
    'all_to_all' replaces the ppermute pairwise exchange with the grouped
    all_to_all lowering and must stay amplitude-exact on an exchange-heavy
    circuit (global H/CX/ucry), chunked and unchunked."""
    rng = np.random.default_rng(5)
    q = 9
    circ = Circuit(q)
    for t in range(q):
        circ.h(t)
    circ.cx(8, 2).ry(0.7, 7).cx(6, 0)
    circ.ucry(rng.uniform(-2, 2, 2 ** (q - 1)), tuple(range(q - 2, -1, -1)), q - 1)
    circ.h(8).swap(7, 1)
    dense = np.asarray(simulate(circ))
    for chunks in (1, 4):
        shard = np.asarray(
            jax.device_get(
                sharded_simulate(
                    circ, mesh8, exchange_impl="all_to_all",
                    exchange_chunks=chunks,
                )
            )
        )
        np.testing.assert_allclose(shard, dense, atol=1e-10)


def test_count_exchanges_dry_run_flag():
    """count_exchanges now runs on the layout's first-class dry_run mode
    (no class-level monkey-patching): the count must match the number of
    exchanges the real executor performs, and concurrent layouts must not
    interfere."""
    from qkan_implementation.sim.sharded import _QubitLayout, count_exchanges

    q = 8
    circ = Circuit(q)
    circ.h(7).cx(6, 0).h(5)
    n = count_exchanges(circ, 8)
    assert n >= 3  # three global qubits touched non-diagonally
    # a fresh real layout is untouched by the dry run (no global state)
    layout = _QubitLayout(q, 5, "d", 8)
    assert layout.exchange_count == 0
    assert not layout.dry_run
    # dry-run layout walks restore() without touching amplitudes
    dry = _QubitLayout(q, 5, "d", 8, dry_run=True)
    out = dry.exchange(None, 6, 0)
    assert out is None and dry.exchange_count == 1
    dry.restore(None)
    assert dry.phys == list(range(q))


def test_exact_amplitudes_20_qubits_both_exchange_impls(mesh8):
    """VERDICT r2 item 5: amplitude-exact sharded-vs-dense at the memory
    edge of the CPU mesh (f64 at q=20 is 1 MB/device here).  Random
    circuit with heavy global-qubit traffic; both exchange
    implementations, chunked and unchunked, must agree to 1e-12."""
    rng = np.random.default_rng(41)
    q = 20
    circ = Circuit(q)
    for t in range(q):
        circ.ry(float(rng.uniform(-2, 2)), t)
    for t in range(q - 4, q):
        circ.h(t)
    circ.cx(q - 1, 0).cx(2, q - 2).swap(q - 3, 1)
    circ.ucry(
        rng.uniform(-2, 2, 2 ** (q - 1)), tuple(range(q - 2, -1, -1)), q - 1
    )
    dense = np.asarray(simulate(circ, dtype=jnp.float64))
    for impl in ("collective", "all_to_all"):
        for chunks in (1, 4):
            shard = np.asarray(
                jax.device_get(
                    sharded_simulate(
                        circ, mesh8, dtype=jnp.float64,
                        exchange_impl=impl, exchange_chunks=chunks,
                    )
                )
            )
            np.testing.assert_allclose(
                shard, dense, atol=1e-12,
                err_msg=f"impl={impl} chunks={chunks}",
            )


def test_exact_amplitudes_19_qubit_fable_circuit(mesh8):
    """A real 512x512 FABLE block-encoding (19 qubits) stays amplitude-
    exact under sharding at f64 -- the workload-shaped counterpart of the
    random-circuit exactness test."""
    from qkan_implementation.encoding import fable

    rng = np.random.default_rng(43)
    a = rng.uniform(-1, 1, (512, 512))
    circ, _ = fable(a)
    assert circ.num_qubits == 19
    dense = np.asarray(simulate(circ, dtype=jnp.float64))
    shard = np.asarray(
        jax.device_get(sharded_simulate(circ, mesh8, dtype=jnp.float64))
    )
    np.testing.assert_allclose(shard, dense, atol=1e-12)


def test_sharded_complex_psi0_promotes_dtype(mesh8):
    """A complex initial state on a real circuit must promote the
    inferred dtype instead of silently dropping the imaginary part
    (review r3: simulate() gained this promotion; the engines must
    agree)."""
    q = 6
    circ = Circuit(q)
    circ.h(0).h(q - 1)
    rng = np.random.default_rng(4)
    psi0 = rng.normal(size=2**q) + 1j * rng.normal(size=2**q)
    psi0 /= np.linalg.norm(psi0)
    want = np.asarray(simulate(circ, psi0=jnp.asarray(psi0)))
    got = np.asarray(
        jax.device_get(
            sharded_simulate(circ, mesh8, psi0=jnp.asarray(psi0))
        )
    )
    assert np.iscomplexobj(got)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_count_exchanges_validates_mesh_size():
    """Non-power-of-two or oversized device counts raise the same clear
    errors sharded_simulate gives (review r3: 6 devices silently modeled
    a 4-device layout)."""
    from qkan_implementation.sim.sharded import count_exchanges

    circ = Circuit(5)
    circ.h(4)
    with pytest.raises(ValueError, match="power of two"):
        count_exchanges(circ, 6)
    with pytest.raises(ValueError, match="more qubits"):
        count_exchanges(circ, 32)


def test_shard_memory_report(mesh8):
    """Per-device accounting reads real buffer bytes: an 8-way sharded f32
    state reports exactly 2^q*4/8 bytes per device and balanced=True; a
    replicated array reports the FULL size on every device (the failure
    mode the dryrun assertion guards against)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qkan_implementation.sim.sharded import shard_memory_report

    q = 10
    circ = Circuit(q)
    for t in range(q):
        circ.ry(0.3 + 0.01 * t, t)
    psi = sharded_simulate(circ, mesh8, dtype=jnp.float32)
    rep = shard_memory_report(psi)
    assert rep["devices"] == 8
    assert rep["balanced"]
    assert rep["max_bytes_per_device"] == 2**q * 4 // 8
    assert rep["total_bytes"] == 2**q * 4

    replicated = jax.device_put(
        jnp.zeros(2**q, jnp.float32), NamedSharding(mesh8, P())
    )
    rep2 = shard_memory_report(replicated)
    assert rep2["devices"] == 8
    assert rep2["max_bytes_per_device"] == 2**q * 4  # full copy per device
    assert not rep2["balanced"]
    assert rep2["total_bytes"] == 8 * rep2["logical_bytes"]
