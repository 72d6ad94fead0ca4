"""Quantum-verified forward + QSVT neuron tests.

Covers the differentiable through-the-simulator path (BASELINE north star)
and the revived test_qsvt_neuron comparison (reference test_qsvt_neuron.py).
"""

import numpy as np
import jax
import jax.numpy as jnp

from qkan_implementation.ops import qkan_layer_forward
from qkan_implementation.ops.quantum import (
    fable_diag_traced,
    qkan_layer_forward_quantum,
    quantum_extract_diag,
    quantum_verify_pipeline,
)
from qkan_implementation.models.qsvt_neuron import (
    QSVTNeuron,
    compare_classical_quantum,
)


def test_quantum_extract_round_trip():
    rng = np.random.default_rng(0)
    diag = jnp.asarray(rng.uniform(-1, 1, 8))
    recovered = quantum_extract_diag(diag)
    np.testing.assert_allclose(np.asarray(recovered), np.asarray(diag), atol=1e-10)


def test_quantum_extract_with_alpha_rescale():
    diag = jnp.asarray([2.0, -3.0, 0.5, 1.0])
    recovered = quantum_extract_diag(diag)
    np.testing.assert_allclose(np.asarray(recovered), np.asarray(diag), atol=1e-8)


def test_quantum_forward_matches_classical():
    rng = np.random.default_rng(1)
    N = K = 4
    d = 3
    x = jnp.asarray(rng.uniform(-1, 1, N))
    w = jnp.asarray(rng.uniform(-1, 1, (d + 1, N * K)))
    classical = qkan_layer_forward(x, w, N, K)
    quantum = qkan_layer_forward_quantum(x, w, N, K)
    np.testing.assert_allclose(
        np.asarray(quantum), np.asarray(classical), atol=1e-8
    )


def test_quantum_forward_non_pow2_padding():
    rng = np.random.default_rng(2)
    N, K = 3, 2  # N*K = 6 -> padded to 8
    d = 2
    x = jnp.asarray(rng.uniform(-1, 1, N))
    w = jnp.asarray(rng.uniform(-1, 1, (d + 1, N * K)))
    classical = qkan_layer_forward(x, w, N, K)
    quantum = qkan_layer_forward_quantum(x, w, N, K)
    np.testing.assert_allclose(np.asarray(quantum), np.asarray(classical), atol=1e-8)


def test_gradients_flow_through_simulator():
    # d(output)/d(weights) through arccos -> ucry -> amplitudes must match
    # the classical layer's gradient (they compute the same function).
    rng = np.random.default_rng(3)
    N = K = 2
    d = 1
    x = jnp.asarray(rng.uniform(-0.9, 0.9, N))
    w = jnp.asarray(rng.uniform(-0.9, 0.9, (d + 1, N * K)))

    g_quantum = jax.grad(
        lambda w: jnp.sum(qkan_layer_forward_quantum(x, w, N, K) ** 2)
    )(w)
    g_classical = jax.grad(
        lambda w: jnp.sum(qkan_layer_forward(x, w, N, K) ** 2)
    )(w)
    np.testing.assert_allclose(
        np.asarray(g_quantum), np.asarray(g_classical), atol=1e-6
    )
    assert np.any(np.abs(np.asarray(g_quantum)) > 1e-8)


def test_pipeline_verification_errors_at_precision():
    rng = np.random.default_rng(4)
    N = K = 2
    d = 2
    x = jnp.asarray(rng.uniform(-1, 1, N))
    w = jnp.asarray(rng.uniform(-1, 1, (d + 1, N * K)))
    errors = quantum_verify_pipeline(x, w, N, K)
    assert set(errors) >= {"cheb_deg0", "mul_deg0", "lcu", "sum"}
    for stage, err in errors.items():
        assert err < 1e-6, f"{stage}: {err}"


def test_qsvt_neuron_classical_vs_quantum():
    # the reference's dead test, alive: quadratic target, degree-2 neuron
    x = np.linspace(-1, 1, 20).reshape(-1, 1)
    y = 0.5 * x**2 + 0.3 * x + 0.1
    classical_mse, quantum_mse, resources = compare_classical_quantum(
        x, y, input_dim=1, max_degree=2
    )
    assert classical_mse < 1e-10
    assert quantum_mse < 1e-6  # encoding round-trip adds only simulator noise
    assert resources["n_qubits"] >= 2 * 5 + 1  # 20 rows pad to 32 = 2^5
    assert resources["alpha_scaling"] >= 1.0
    assert resources["gate_count"] > 0


def test_qsvt_neuron_forward_requires_fit():
    neuron = QSVTNeuron(input_dim=1, max_degree=2)
    try:
        neuron.forward(np.zeros((2, 1)))
        raise AssertionError("expected RuntimeError")
    except RuntimeError:
        pass


def test_packed_extraction_matches_strict():
    from qkan_implementation.ops.quantum import quantum_extract_diag_packed

    rng = np.random.default_rng(6)
    diag = jnp.asarray(rng.uniform(-1, 1, 16))
    packed = quantum_extract_diag_packed(diag)
    strict = quantum_extract_diag(diag)
    np.testing.assert_allclose(np.asarray(packed), np.asarray(strict), atol=1e-10)
    np.testing.assert_allclose(np.asarray(packed), np.asarray(diag), atol=1e-10)


def test_quantum_grad_training_n16_k16_fast():
    # VERDICT r1 item 2 "done" criterion: gradient through the simulator at
    # N=K=16 in seconds.  The packed extractor makes the layer forward ONE
    # 2^17-amplitude simulation per sample instead of 256 of them.
    import time

    from qkan_implementation.ops.quantum import (
        qkan_layer_forward_quantum_batched,
    )
    from qkan_implementation.ops.qkan_layer import qkan_layer_forward_batched

    rng = np.random.default_rng(7)
    N = K = 16
    d = 7
    B = 4
    x = jnp.asarray(rng.uniform(-0.9, 0.9, (B, N)))
    w = jnp.asarray(rng.uniform(-0.9, 0.9, (d + 1, N * K)))

    def loss_q(w):
        return jnp.sum(qkan_layer_forward_quantum_batched(x, w, N, K) ** 2)

    def loss_c(w):
        return jnp.sum(qkan_layer_forward_batched(x, w, N, K) ** 2)

    start = time.time()
    g_q = jax.jit(jax.grad(loss_q))(w)
    g_q.block_until_ready()
    elapsed = time.time() - start
    g_c = jax.grad(loss_c)(w)
    np.testing.assert_allclose(np.asarray(g_q), np.asarray(g_c), atol=1e-6)
    assert np.any(np.abs(np.asarray(g_q)) > 1e-8)
    assert elapsed < 120, f"compile+grad took {elapsed:.1f}s"


def test_block_column_extraction_matches_matrix():
    from qkan_implementation.ops.quantum import quantum_extract_block_columns

    rng = np.random.default_rng(8)
    a = rng.uniform(-1, 1, (6, 5))  # non-square, non-pow2 -> padded to 8x8
    rec = quantum_extract_block_columns(a, chunk=3)
    np.testing.assert_allclose(rec, a, atol=1e-10)


def test_fixed_kan_quantum_mode_capped():
    from qkan_implementation.models.fixed_kan import FixedKAN, FixedKANConfig

    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (40, 2))
    y = 0.5 * x[:, :1] ** 2 + 0.3 * x[:, 1:] + 0.1
    cfg = FixedKANConfig(
        network_shape=[2, 1],
        max_degree=2,
        quantum_sample_cap=16,
        consistent_tanh=True,
        degree_objective="penalized_mse",
        complexity_weight=1e-3,
    )
    model = FixedKAN(cfg)
    model.optimize(x, y, use_quantum=True, solver="exact")
    pred = np.asarray(model(x))
    assert float(np.mean((pred - y) ** 2)) < 0.05
    res = model.last_quantum_resources
    assert res and all(r["rows_encoded"] == 16 for r in res)
    assert all(r["columns_simulated"] <= 6 for r in res)


class TestShardedQuantumMode:
    """Quantum-mode layer with the block encoding sharded over the mesh
    (ops.quantum.qkan_layer_forward_quantum_sharded): the scaling mode for
    encodings past one device's HBM.  Forward AND gradient must match the
    dense quantum path bitwise-tight; traced angles ride into shard_map as
    runtime operands (sharded_simulate(runtime_params=...))."""

    def _mesh(self):
        import jax
        import pytest

        if len(jax.devices()) < 8:
            pytest.skip("needs the 8-device CPU mesh")
        from qkan_implementation.parallel import make_mesh

        return make_mesh(8, axis_name="d")

    def test_forward_matches_dense_quantum(self):
        import jax.numpy as jnp
        from qkan_implementation.ops.quantum import (
            qkan_layer_forward_quantum,
            qkan_layer_forward_quantum_sharded,
        )

        mesh = self._mesh()
        rng = np.random.default_rng(0)
        N = K = 8
        x = jnp.asarray(rng.uniform(-1, 1, N))
        w = jnp.asarray(rng.uniform(-0.5, 0.5, (4, N * K)))
        dense = qkan_layer_forward_quantum(x, w, N, K)
        shard = qkan_layer_forward_quantum_sharded(x, w, N, K, mesh)
        np.testing.assert_allclose(
            np.asarray(shard), np.asarray(dense), atol=1e-14
        )

    def test_gradient_matches_dense_quantum(self):
        import jax
        import jax.numpy as jnp
        from qkan_implementation.ops.quantum import (
            qkan_layer_forward_quantum,
            qkan_layer_forward_quantum_sharded,
        )

        mesh = self._mesh()
        rng = np.random.default_rng(1)
        N = K = 8
        x = jnp.asarray(rng.uniform(-1, 1, N))
        w = jnp.asarray(rng.uniform(-0.5, 0.5, (4, N * K)))

        def loss_d(w):
            return jnp.sum(qkan_layer_forward_quantum(x, w, N, K) ** 2)

        def loss_s(w):
            return jnp.sum(
                qkan_layer_forward_quantum_sharded(x, w, N, K, mesh) ** 2
            )

        gd = jax.grad(loss_d)(w)
        gs = jax.grad(loss_s)(w)
        assert float(jnp.linalg.norm(gd)) > 0
        np.testing.assert_allclose(
            np.asarray(gs), np.asarray(gd), atol=1e-14
        )

    def test_runtime_params_override_static_circuit(self):
        # sharded_simulate(runtime_params=...) must override the stored
        # gate parameters, not silently ignore them
        import jax
        import jax.numpy as jnp
        from qkan_implementation.sim import Circuit, simulate
        from qkan_implementation.sim.sharded import sharded_simulate

        mesh = self._mesh()
        q = 6
        rng = np.random.default_rng(2)
        old = rng.uniform(-np.pi, np.pi, 2 ** (q - 1))
        new = rng.uniform(-np.pi, np.pi, 2 ** (q - 1))
        circ = Circuit(q)
        for t in range(q):
            circ.h(t)
        circ.ucry(old, tuple(range(q - 2, -1, -1)), q - 1)
        ref = Circuit(q)
        for t in range(q):
            ref.h(t)
        ref.ucry(new, tuple(range(q - 2, -1, -1)), q - 1)
        dense_new = np.asarray(simulate(ref))
        shard = np.asarray(
            jax.device_get(
                sharded_simulate(
                    circ, mesh, runtime_params={q: jnp.asarray(new)}
                )
            )
        )
        np.testing.assert_allclose(shard, dense_new, atol=1e-12)


def test_quantum_grad_finite_f32_at_saturation():
    """f32 regression: entries with |d| >= 1 (alpha active) must keep
    gradients finite.  A fixed (1 + 1e-8) subnormalization margin rounds to
    exactly 1.0 in f32, putting arccos at +/-1 where its derivative is
    -inf and every gradient NaN; the margin is now dtype-aware
    (ops/quantum.py fable_diag_traced)."""
    from qkan_implementation.ops.quantum import quantum_extract_diag_packed

    diag = jnp.asarray([1.5, 0.3, -0.2, 0.7], dtype=jnp.float32)

    def loss(d):
        return jnp.sum(quantum_extract_diag_packed(d) ** 2)

    g = jax.grad(loss)(diag)
    assert g.dtype == jnp.float32
    assert np.all(np.isfinite(np.asarray(g))), g
    # forward accuracy survives the margin: round trip within f32 rounding
    rec = quantum_extract_diag_packed(diag)
    np.testing.assert_allclose(np.asarray(rec), np.asarray(diag), atol=1e-4)


def test_extract_block_columns_integer_input():
    """Integer design matrices must come back as floats (review r3: the
    output buffer inherited a.dtype and silently truncated every
    recovered amplitude to 0)."""
    import numpy as np
    from qkan_implementation.ops.quantum import (
        quantum_extract_block_columns,
    )

    a = np.eye(4, dtype=np.int64)
    out = quantum_extract_block_columns(a)
    assert np.issubdtype(out.dtype, np.floating)
    np.testing.assert_allclose(out, a.astype(float), atol=1e-6)


def test_sharded_packed_extraction_reuses_executor_cache():
    """Repeat eager calls must hit the compiled-executor cache (review
    r3: a fresh Circuit per call carried a fresh cache, re-tracing and
    re-compiling the shard_map executor every time -- the compile cost
    the cache exists to remove)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from qkan_implementation.ops.quantum import (
        _diag_circuit_template,
        quantum_extract_diag_packed_sharded,
    )

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 virtual devices")
    mesh = Mesh(np.array(jax.devices()[:8]), ("d",))
    rng = np.random.default_rng(0)
    d1 = jnp.asarray(rng.uniform(-1, 1, 64))
    d2 = jnp.asarray(rng.uniform(-1, 1, 64))
    out1 = quantum_extract_diag_packed_sharded(d1, mesh)
    circ, _ = _diag_circuit_template(6)
    cache = getattr(circ, "_sharded_exec_cache", None)
    assert cache is not None and len(cache) == 1
    out2 = quantum_extract_diag_packed_sharded(d2, mesh)
    assert len(getattr(circ, "_sharded_exec_cache")) == 1  # HIT, no new entry
    np.testing.assert_allclose(np.asarray(out1), np.asarray(d1), atol=5e-3)
    np.testing.assert_allclose(np.asarray(out2), np.asarray(d2), atol=5e-3)
