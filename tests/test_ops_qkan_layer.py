"""Golden tests for the fused QKAN layer against a reference-faithful oracle.

The oracle below re-derives the reference semantics independently with dense
NumPy matrices, exactly as ``QKAN_Steps_original/QKANLayer.py:124-135`` does
(dense diagonals, Fortran-order SUM reshape), and the fused JAX pipeline must
match it.  Shapes/cases mirror ``QKANLayer.py:138-270``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qkan_implementation.ops import (
    qkan_layer_forward,
    qkan_layer_forward_batched,
    qkan_layer_forward_batched_int8,
    qkan_intermediates,
)


def oracle_forward(x, weights, N, K):
    """Dense-matrix oracle replicating reference QKANLayer.forward."""
    max_degree = len(weights) - 1
    combined = np.zeros((N * K, N * K))
    for d in range(max_degree + 1):
        cheb = np.cos(d * np.arccos(np.clip(x, -1, 1)))
        dilated = np.diag(np.repeat(cheb, K))
        weighted = np.diag(np.diag(dilated) * weights[d])
        combined += weighted / (max_degree + 1)
    lcu_diag = np.diag(combined)
    reshaped = lcu_diag.reshape(N, K, order="F")
    return np.sum(reshaped, axis=0) / N


@pytest.mark.parametrize(
    "N,K,d",
    [(4, 4, 3), (4, 8, 2), (8, 4, 2), (2, 2, 1), (3, 5, 4)],
)
def test_forward_matches_oracle(N, K, d):
    rng = np.random.default_rng(42)
    x = rng.uniform(-1, 1, N)
    weights = rng.uniform(-1, 1, (d + 1, N * K))

    ours = qkan_layer_forward(jnp.asarray(x), jnp.asarray(weights), N, K)
    expected = oracle_forward(x, weights, N, K)

    assert ours.shape == (K,)
    np.testing.assert_allclose(ours, expected, atol=1e-12)
    # Output bound contract (reference QKANLayer.py:160,212,248)
    assert np.all(np.abs(np.asarray(ours)) <= 1 + 1e-12)


def test_forward_jit_and_grad():
    N, K, d = 4, 4, 3
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1, 1, N))
    w = jnp.asarray(rng.uniform(-1, 1, (d + 1, N * K)))

    f = jax.jit(lambda x, w: qkan_layer_forward(x, w, N, K))
    np.testing.assert_allclose(f(x, w), qkan_layer_forward(x, w, N, K), atol=1e-12)

    # Differentiable end-to-end (the reference's quantum path is forward-only)
    g = jax.grad(lambda w: jnp.sum(qkan_layer_forward(x, w, N, K) ** 2))(w)
    assert g.shape == w.shape
    assert np.all(np.isfinite(np.asarray(g)))

    # Analytic gradient check on a single weight: out[k] depends linearly on w
    eps = 1e-6
    w2 = w.at[1, 0].add(eps)
    fd = (jnp.sum(qkan_layer_forward(x, w2, N, K) ** 2) -
          jnp.sum(qkan_layer_forward(x, w, N, K) ** 2)) / eps
    np.testing.assert_allclose(g[1, 0], fd, rtol=1e-4)


def test_batched_forward():
    N, K, d, B = 4, 4, 3, 16
    rng = np.random.default_rng(1)
    xb = rng.uniform(-1, 1, (B, N))
    w = rng.uniform(-1, 1, (d + 1, N * K))

    out = qkan_layer_forward_batched(jnp.asarray(xb), jnp.asarray(w), N, K)
    assert out.shape == (B, K)
    for b in range(B):
        np.testing.assert_allclose(
            out[b], oracle_forward(xb[b], w, N, K), atol=1e-12
        )


def test_batched_forward_bf16io_recipe():
    """compute_dtype=bfloat16 (the production mixed-precision recipe,
    docs/benchmarks.md 'bf16io'): f32-accumulated output, within bf16
    rounding of the exact path, and bf16-stored inputs give the identical
    result (the cast is idempotent)."""
    N, K, d, B = 4, 4, 3, 64
    rng = np.random.default_rng(9)
    xb = jnp.asarray(rng.uniform(-1, 1, (B, N)), dtype=jnp.float32)
    w = jnp.asarray(rng.uniform(-1, 1, (d + 1, N * K)), dtype=jnp.float32)

    exact = qkan_layer_forward_batched(xb, w, N, K)
    mixed = qkan_layer_forward_batched(
        xb, w, N, K, compute_dtype=jnp.bfloat16
    )
    assert mixed.dtype == jnp.float32
    np.testing.assert_allclose(
        np.asarray(mixed), np.asarray(exact), atol=3e-2
    )
    pre_cast = qkan_layer_forward_batched(
        xb.astype(jnp.bfloat16), w, N, K, compute_dtype=jnp.bfloat16
    )
    np.testing.assert_array_equal(np.asarray(pre_cast), np.asarray(mixed))


def test_zero_input_gives_near_zero_output():
    # reference QKANLayer.py:250-252: zero input -> ~0 output.  With x = 0,
    # T_0 = 1 and T_1 = 0, T_2 = -1, ... so output is the weighted mean of
    # even-degree terms; the reference asserts ~0 only because the mean of
    # uniform weights vanishes statistically.  We pin the deterministic case:
    # only degree-1 weights nonzero -> exactly 0.
    N = K = 4
    w = np.zeros((2, N * K))
    w[1] = 0.7
    out = qkan_layer_forward(jnp.zeros(N), jnp.asarray(w), N, K)
    np.testing.assert_allclose(out, np.zeros(K), atol=1e-12)


def test_edge_cases_match_oracle():
    N = K = 4
    d = 3
    rng = np.random.default_rng(2)
    weights = rng.uniform(-1, 1, (d + 1, N * K))
    for x in [
        np.zeros(N),
        np.array([-1.0, -1.0, 1.0, 1.0]),
        np.ones(N) * 0.5,
    ]:
        ours = qkan_layer_forward(jnp.asarray(x), jnp.asarray(weights), N, K)
        np.testing.assert_allclose(ours, oracle_forward(x, weights, N, K), atol=1e-12)
        assert np.all(np.abs(np.asarray(ours)) <= 1 + 1e-12)


def test_intermediates_shapes_and_values():
    # Mirrors reference QKANLayer.get_intermediate_matrices checks
    # (QKANLayer.py:163-190) on the diagonal representation.
    N, K, d = 4, 4, 3
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, N)
    w = rng.uniform(-1, 1, (d + 1, N * K))

    inter = qkan_intermediates(jnp.asarray(x), jnp.asarray(w), N, K)
    assert inter["cheb"][0].shape == (N * K,)
    assert inter["weighted"][0].shape == (N * K,)
    assert inter["lcu"].shape == (N * K,)
    assert inter["reshaped"].shape == (N, K)
    assert inter["final"].shape == (K,)

    for deg in range(d + 1):
        assert np.all(np.abs(np.asarray(inter["weighted"][deg])) <= 1 + 1e-12)
    assert np.all(np.abs(np.asarray(inter["lcu"])) <= 1 + 1e-12)

    # Fortran-order reshape: reshaped[i, k] == lcu[i + k*N]
    lcu = np.asarray(inter["lcu"])
    np.testing.assert_allclose(
        inter["reshaped"], lcu.reshape(N, K, order="F"), atol=0
    )
    np.testing.assert_allclose(inter["final"], oracle_forward(x, w, N, K), atol=1e-12)


def test_degree_sweep_stability():
    # reference QKANLayer.py:254-270: 1/(d+1)-scaled weights stay bounded.
    N = K = 4
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, N)
    for d in [1, 3, 5, 10]:
        w = np.stack(
            [rng.uniform(-1 / (deg + 1), 1 / (deg + 1), N * K) for deg in range(d + 1)]
        )
        out = qkan_layer_forward(jnp.asarray(x), jnp.asarray(w), N, K)
        np.testing.assert_allclose(out, oracle_forward(x, w, N, K), atol=1e-12)
        assert np.all(np.abs(np.asarray(out)) <= 1)


def test_batched_forward_int8_serving_path():
    """The int8 serving path (static 127 activation scale, per-output-
    channel weight scale, int32 accumulate): f32 output within the declared
    ~1e-3 absolute error of the exact path at the headline shape, and the
    quantization is deterministic."""
    N = K = 16
    d, B = 7, 256
    rng = np.random.default_rng(11)
    xb = jnp.asarray(rng.uniform(-1, 1, (B, N)), dtype=jnp.float32)
    w = jnp.asarray(rng.uniform(-1, 1, (d + 1, N * K)), dtype=jnp.float32)
    exact = np.asarray(qkan_layer_forward_batched(xb, w, N, K))
    q = np.asarray(qkan_layer_forward_batched_int8(xb, w, N, K))
    assert q.dtype == np.float32
    err = np.max(np.abs(q - exact))
    assert err < 2e-3, err
    # typical-magnitude relative error is sub-percent (quantization noise
    # averages down over the N*(D+1)-term contraction)
    scale = np.median(np.abs(exact))
    assert np.median(np.abs(q - exact)) < 0.02 * scale
    q2 = np.asarray(qkan_layer_forward_batched_int8(xb, w, N, K))
    np.testing.assert_array_equal(q, q2)


def test_batched_forward_int8_jits_and_handles_edges():
    """jit-compatible; exact-zero weights give exact-zero outputs (the
    1e-30 scale guard avoids 0/0); boundary inputs quantize in range."""
    N = K = 4
    d = 3
    w0 = jnp.zeros((d + 1, N * K), dtype=jnp.float32)
    x = jnp.asarray([[-1.0, -0.5, 0.5, 1.0]], dtype=jnp.float32)
    out = jax.jit(
        lambda x, w: qkan_layer_forward_batched_int8(x, w, N, K)
    )(x, w0)
    np.testing.assert_array_equal(np.asarray(out), 0.0)
    rng = np.random.default_rng(3)
    w = jnp.asarray(rng.uniform(-1, 1, (d + 1, N * K)), dtype=jnp.float32)
    got = np.asarray(qkan_layer_forward_batched_int8(x, w, N, K))
    ref = np.asarray(qkan_layer_forward_batched(x, w, N, K))
    np.testing.assert_allclose(got, ref, atol=2e-3)

def test_batched_forward_int8_f32_output_under_x64():
    """Regression (review r3): with x64 enabled, f64 inputs/weights made the
    dequant scale f64, silently promoting the documented float32 output to
    float64.  The shared ``int8_quantized_matmul`` casts the scale."""
    from qkan_implementation.ops.qkan_layer import int8_quantized_matmul

    N = K = 8
    d = 3
    rng = np.random.default_rng(5)
    # plain numpy f64 -> jnp keeps f64 under the suite's x64 mode
    xb = jnp.asarray(rng.uniform(-1, 1, (16, N)))
    w = jnp.asarray(rng.uniform(-1, 1, (d + 1, N * K)))
    assert w.dtype == jnp.float64  # precondition: the suite runs x64
    out = qkan_layer_forward_batched_int8(xb, w, N, K)
    assert out.dtype == jnp.float32
    # the shared helper holds the same contract directly
    basis2d = jnp.asarray(rng.uniform(-1, 1, (16, 32)))
    W = jnp.asarray(rng.uniform(-1, 1, (32, K)))
    assert int8_quantized_matmul(basis2d, W).dtype == jnp.float32
