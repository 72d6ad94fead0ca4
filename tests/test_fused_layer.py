"""Fused FixedKAN layer kernel (ops/fused_layer.py) vs the XLA path.

The kernel's arithmetic runs here in Pallas interpret mode; the compiled
Triton kernel runs only on a GPU (the ``gpu``-marked cases, and phase 6 of
chip_smoke.py).  The wrapper's padding, layout, gradient rule and backend
choice are plain Python and are tested here directly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import qkan_implementation.models.fixed_kan as fk
from qkan_implementation.models.fixed_kan import (
    choose_layer_backend,
    kan_apply,
    kan_layer_apply,
)
from qkan_implementation.ops import fused_layer
from qkan_implementation.ops.fused_layer import kan_layer_fused


def random_layer(rng, in_dim, out, T, D, ragged=True, dtype=np.float32):
    degs = (
        rng.integers(0, D + 1, out) if ragged else np.full(out, D)
    ).astype(np.int32)
    return {
        "degrees": jnp.asarray(degs),
        "coefficients": jnp.asarray(
            rng.normal(0, 0.3, (out, in_dim, D + 1, T)).astype(dtype)
        ),
        "horizontal_weights": jnp.asarray(rng.normal(0, 1, out).astype(dtype)),
    }


def _uniform(rng, lo, hi, shape):
    return jnp.asarray(rng.uniform(lo, hi, shape), jnp.float32)


def _degree_major_reference(x, w_dm, dp1):
    t = np.tanh(np.asarray(x, np.float64))
    ts = [np.ones_like(t), t]
    for _ in range(2, dp1):
        ts.append(2.0 * t * ts[-1] - ts[-2])
    return np.concatenate(ts[:dp1], axis=1) @ np.asarray(w_dm)


# batch / input widths straddle the 64-row and 32-column tiles; T spans
# the 16-wide floor of the Triton dot and a padded 17 -> 32
@pytest.mark.parametrize(
    "in_dim,out,T,D,batch",
    [(23, 7, 4, 5, 37), (33, 3, 17, 3, 70), (64, 2, 10, 5, 65), (5, 2, 1, 0, 9)],
)
def test_fused_forward_matches_xla_backend(in_dim, out, T, D, batch):
    rng = np.random.default_rng(in_dim)
    lp = random_layer(rng, in_dim, out, T, D)
    x = _uniform(rng, -2, 2, (batch, in_dim))
    want = np.asarray(kan_layer_apply(lp, x, D, backend="xla"))
    got = np.asarray(kan_layer_apply(lp, x, D, backend="fused"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("in_dim,out,T,D,batch", [(11, 5, 3, 4, 19), (40, 3, 12, 2, 67)])
def test_fused_gradients_match_xla_backend(in_dim, out, T, D, batch):
    """The custom VJP (dW kernel, plain-jnp dx) against autodiff of the XLA
    layer, through the coefficient fold."""
    rng = np.random.default_rng(batch)
    lp = random_layer(rng, in_dim, out, T, D)
    x = _uniform(rng, -1.5, 1.5, (batch, in_dim))
    y = jnp.asarray(rng.normal(0, 1, (batch, T)), jnp.float32)
    degs = lp["degrees"]

    def loss(tp, x, backend):
        out = kan_layer_apply(dict(tp, degrees=degs), x, D, backend=backend)
        return jnp.mean((out - y) ** 2)

    tp = {k: v for k, v in lp.items() if k != "degrees"}
    (gp_x, gx_x) = jax.grad(loss, argnums=(0, 1))(tp, x, "xla")
    (gp_f, gx_f) = jax.grad(loss, argnums=(0, 1))(tp, x, "fused")
    np.testing.assert_allclose(
        np.asarray(gx_f), np.asarray(gx_x), rtol=1e-4, atol=1e-6
    )
    for k in ("coefficients", "horizontal_weights"):
        np.testing.assert_allclose(
            np.asarray(gp_f[k]), np.asarray(gp_x[k]),
            rtol=1e-4, atol=1e-6, err_msg=k,
        )


def test_fused_multi_layer_and_jit():
    rng = np.random.default_rng(2)
    D = 3
    params = [random_layer(rng, 6, 4, 5, D), random_layer(rng, 5, 3, 2, D)]
    x = _uniform(rng, -1, 1, (16, 6))
    want = np.asarray(kan_apply(params, x, D))
    got = np.asarray(
        jax.jit(lambda p, x: kan_apply(p, x, D, backend="fused"))(params, x)
    )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cd", [jnp.bfloat16, jnp.int8, "int8x2"])
def test_fused_rejects_compute_dtypes(cd):
    rng = np.random.default_rng(4)
    lp = random_layer(rng, 4, 2, 2, 2)
    x = _uniform(rng, -1, 1, (8, 4))
    with pytest.raises(ValueError, match="f32 only"):
        kan_layer_apply(lp, x, 2, cd, backend="fused")


@pytest.mark.parametrize("x_f64,w_f64", [(True, True), (True, False), (False, True)])
def test_fused_rejects_f64_layers(x_f64, w_f64):
    """The kernel computes in f32: an explicit backend='fused' on an f64
    layer raises instead of silently rounding it to f32 (x64 is on)."""
    rng = np.random.default_rng(4)
    lp = random_layer(rng, 4, 2, 2, 2, dtype=np.float64 if w_f64 else np.float32)
    x = jnp.asarray(rng.uniform(-1, 1, (8, 4)), jnp.float64 if x_f64 else jnp.float32)
    with pytest.raises(ValueError, match="f32 only"):
        kan_layer_apply(lp, x, 2, backend="fused")
    # 'auto' keeps such a layer on XLA, in f64
    assert kan_layer_apply(lp, x, 2).dtype == jnp.float64


def test_fused_rejects_precision_without_a_kernel_mode():
    rng = np.random.default_rng(4)
    lp = random_layer(rng, 4, 2, 2, 2)
    x = _uniform(rng, -1, 1, (8, 4))
    with pytest.raises(ValueError, match="no mode"):
        kan_layer_apply(lp, x, 2, backend="fused", matmul_precision="highest")


def test_fused_raw_op_degree_major_contract():
    """kan_layer_fused consumes DEGREE-MAJOR w[d*in + i, t]."""
    rng = np.random.default_rng(5)
    in_dim, T, dp1 = 9, 2, 4
    w_dm = jnp.asarray(rng.normal(0, 1, (dp1 * in_dim, T)))
    x = jnp.asarray(rng.uniform(-2, 2, (13, in_dim)))
    got = np.asarray(kan_layer_fused(x, w_dm, dp1, interpret=True))
    want = _degree_major_reference(x, w_dm, dp1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fused_bf16x3_mode_matches_default():
    """'bf16x3' (three bf16 passes) is f32-accurate: it agrees with the
    exact interpret-mode dot to f32 rounding."""
    rng = np.random.default_rng(6)
    in_dim, T, dp1 = 45, 10, 6
    w_dm = jnp.asarray(rng.normal(0, 0.1, (dp1 * in_dim, T)), jnp.float32)
    x = jnp.asarray(rng.uniform(-2, 2, (70, in_dim)), jnp.float32)
    got = np.asarray(kan_layer_fused(x, w_dm, dp1, "bf16x3", interpret=True))
    want = _degree_major_reference(x, w_dm, dp1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_fused_unknown_precision_raises():
    x = jnp.zeros((4, 3))
    w = jnp.zeros((6, 2))
    with pytest.raises(KeyError):
        kan_layer_fused(x, w, 2, "highest", interpret=True)


@pytest.mark.parametrize("mode", ["default", "bf16x3"])
def test_fused_gradients_match_reference_per_mode(mode):
    """Both cotangents of the raw op in each kernel mode against the f64
    NumPy derivatives: dW = T(t)^T g and dx = (1 - t^2) sum_d T'_d(t) *
    (g @ W_d^T), with T'_d = d U_{d-1}."""
    rng = np.random.default_rng(7)
    B, n, T, dp1 = 70, 40, 12, 6
    x = _uniform(rng, -2, 2, (B, n))
    w = jnp.asarray(rng.normal(0, 0.3, (dp1 * n, T)), jnp.float32)
    g = jnp.asarray(rng.normal(size=(B, T)), jnp.float32)
    dx, dw = jax.grad(
        lambda x, w: jnp.sum(kan_layer_fused(x, w, dp1, mode, interpret=True) * g),
        argnums=(0, 1),
    )(x, w)
    t = np.tanh(np.asarray(x, np.float64))
    ts, us = [np.ones_like(t), t], [np.ones_like(t), 2 * t]
    for _ in range(2, dp1):
        ts.append(2 * t * ts[-1] - ts[-2])
        us.append(2 * t * us[-1] - us[-2])
    g64 = np.asarray(g, np.float64)
    w3 = np.asarray(w, np.float64).reshape(dp1, n, T)
    dw_want = np.concatenate(ts, axis=1).T @ g64
    dx_want = (1 - t * t) * sum(
        d * us[d - 1] * (g64 @ w3[d].T) for d in range(1, dp1)
    )
    np.testing.assert_allclose(np.asarray(dw), dw_want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dx), dx_want, rtol=1e-4, atol=1e-4)


def test_pad_weights_layout():
    """Degree-major [dp1*in, T] -> [dp1, in_pad, T_pad], zeros in the pad,
    in_pad a multiple of the column chunk and T_pad a power of two >= 16."""
    rng = np.random.default_rng(9)
    dp1, cols, T = 3, 45, 17
    w = rng.normal(size=(dp1 * cols, T)).astype(np.float32)
    wp = np.asarray(fused_layer._pad_weights(jnp.asarray(w), dp1, cols))
    assert wp.shape[0] == dp1
    assert wp.shape[1] % fused_layer._BN == 0 and wp.shape[1] >= cols
    assert wp.shape[2] == 32
    np.testing.assert_array_equal(wp[:, :cols, :T], w.reshape(dp1, cols, T))
    assert not wp[:, cols:, :].any() and not wp[:, :, T:].any()
    assert fused_layer._pad_t(10) == 16 and fused_layer._pad_t(16) == 16


def test_backward_returns_input_dtypes():
    """dx and dW come back in the input dtypes (f64 under x64)."""
    rng = np.random.default_rng(10)
    x = jnp.asarray(rng.uniform(-1, 1, (9, 5)))
    w = jnp.asarray(rng.normal(size=(15, 3)))
    dx, dw = jax.grad(
        lambda x, w: jnp.sum(kan_layer_fused(x, w, 3, interpret=True)),
        argnums=(0, 1),
    )(x, w)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    assert dx.shape == x.shape and dw.shape == w.shape


# -- backend choice ----------------------------------------------------------


def test_choose_backend_is_xla_off_the_gpu():
    assert jax.default_backend() == "cpu"
    assert choose_layer_backend(4704, None, None, jnp.float32) == "xla"


F32, F64 = jnp.float32, jnp.float64


@pytest.mark.parametrize(
    "fan_in,compute_dtype,precision,dtype,want",
    [
        (4704, None, None, F32, "fused"),  # flagship layer 0, training (TF32)
        (4704, None, "BF16_BF16_F32_X3", F32, "fused"),  # layer 0, serving
        (512, None, None, F32, "fused"),  # the wide-layer threshold
        (511, None, None, F32, "xla"),  # narrow: XLA's matmul is as fast
        (60, None, None, F32, "xla"),  # flagship hidden layers
        (4704, None, "highest", F32, "xla"),  # no full-f32 kernel mode
        (4704, None, "high", F32, "xla"),
        (4704, jnp.bfloat16, None, F32, "xla"),  # bf16io recipe
        (4704, "int8x2", None, F32, "xla"),
        (4704, None, None, F64, "xla"),  # f64 layer: the kernel is f32
        (4704, None, "default", F64, "xla"),
    ],
)
def test_choose_backend_on_gpu(monkeypatch, fan_in, compute_dtype, precision,
                               dtype, want):
    monkeypatch.setattr(fk.jax, "default_backend", lambda: "gpu")
    assert choose_layer_backend(fan_in, compute_dtype, precision, dtype) == want


@pytest.mark.parametrize(
    "precision,mode",
    [(None, "default"), ("default", "default"),
     ("BF16_BF16_F32_X3", "bf16x3"), ("highest", None), ("high", None)],
)
def test_kernel_mode_mapping(precision, mode):
    assert fk._kernel_mode(precision) == mode


def test_auto_backend_reads_the_ambient_precision(monkeypatch):
    """backend='auto' with matmul_precision=None follows the ambient
    jax.default_matmul_precision: a 'highest' context keeps XLA."""
    seen = []
    monkeypatch.setattr(
        fk, "choose_layer_backend",
        lambda fan_in, cd, prec, dtype: seen.append(prec) or "xla",
    )
    rng = np.random.default_rng(11)
    lp = random_layer(rng, 4, 2, 2, 2)
    x = _uniform(rng, -1, 1, (8, 4))
    with jax.default_matmul_precision("highest"):
        kan_layer_apply(lp, x, 2, matmul_precision=None)
    kan_layer_apply(lp, x, 2, matmul_precision=None)
    assert seen == ["highest", None]


# -- on the card ---------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["default", "bf16x3"])
def test_compiled_kernel_matches_reference_on_gpu(gpu, mode):
    """The Triton-compiled kernel at the flagship layer-0 width, forward
    and weight gradient, against a full-f32 XLA reference."""
    rng = np.random.default_rng(12)
    B, n, T, dp1 = 2048, 784, 10, 6
    x = jnp.asarray(rng.uniform(0, 1, (B, n)), jnp.float32)
    w = jnp.asarray(rng.normal(0, 0.02, (dp1 * n, T)), jnp.float32)
    g = jnp.asarray(rng.normal(size=(B, T)), jnp.float32)
    want = _degree_major_reference(x, w, dp1)
    got = np.asarray(jax.jit(lambda x, w: kan_layer_fused(x, w, dp1, mode))(x, w))
    tol = 2e-3 if mode == "default" else 1e-5  # TF32 keeps 11 bits
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < tol
    t = np.tanh(np.asarray(x, np.float64))
    ts = [np.ones_like(t), t]
    for _ in range(2, dp1):
        ts.append(2.0 * t * ts[-1] - ts[-2])
    dw_want = np.concatenate(ts, axis=1).T @ np.asarray(g, np.float64)
    dw = np.asarray(jax.jit(jax.grad(
        lambda w: jnp.sum(kan_layer_fused(x, w, dp1, mode) * g)
    ))(w))
    assert np.max(np.abs(dw - dw_want)) / np.max(np.abs(dw_want)) < tol
