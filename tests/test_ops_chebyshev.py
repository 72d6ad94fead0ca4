"""Golden tests for the Chebyshev step ops.

Mirrors the reference test strategy in
``QKAN_Steps_original/ChebyshevStep.py:68-115`` (exact values, vector
transforms, dilation layout, input validation) with NumPy as the independent
oracle.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from qkan_implementation.ops import (
    chebyshev_t,
    chebyshev_basis,
    cumulative_transform,
    transform_diagonal,
    dilate,
    dilated_chebyshev_diag,
    check_unit_interval,
    check_weight_magnitudes,
)


def test_simple_chebyshev():
    # T_1(x) = x, T_2(x) = 2x^2 - 1 (reference ChebyshevStep.py:69-83)
    x = 0.5
    np.testing.assert_allclose(chebyshev_t(jnp.asarray(x), 1), x, atol=1e-12)
    np.testing.assert_allclose(
        chebyshev_t(jnp.asarray(x), 2), 2 * x**2 - 1, atol=1e-12
    )


def test_vector_transform():
    x = np.array([0.5, -0.5, 0.0])
    result = transform_diagonal(jnp.asarray(x), 2)
    np.testing.assert_allclose(result, 2 * x**2 - 1, atol=1e-12)


@pytest.mark.parametrize("degree", range(9))
def test_basis_matches_cos_arccos(degree):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=64)
    via_recurrence = chebyshev_basis(jnp.asarray(x), degree)[..., degree]
    via_cos = np.cos(degree * np.arccos(x))
    np.testing.assert_allclose(via_recurrence, via_cos, atol=1e-12)


def test_dilation_layout():
    # np.repeat semantics: index n*K + k holds value n
    # (reference ChebyshevStep.py:96-101)
    x = np.array([0.5, -0.5])
    result = dilated_chebyshev_diag(jnp.asarray(x), K=2, degree=1)
    np.testing.assert_allclose(result, [0.5, 0.5, -0.5, -0.5], atol=1e-12)


def test_dilate_general():
    vals = np.array([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(dilate(jnp.asarray(vals), 3), np.repeat(vals, 3))


def test_clipping_of_slightly_out_of_range():
    # Values within eps of the boundary are clipped, not rejected
    # (reference ChebyshevStep.py:25-30).
    x = jnp.asarray([1.0 + 5e-9, -1.0 - 5e-9])
    out = chebyshev_t(x, 3)
    np.testing.assert_allclose(out, [1.0, -1.0], atol=1e-12)


def test_input_validation():
    # ValueError contract (reference ChebyshevStep.py:103-115)
    with pytest.raises(ValueError):
        check_unit_interval(1.5)
    with pytest.raises(ValueError):
        check_unit_interval(np.array([1.5, 0.5]))
    with pytest.raises(ValueError):
        chebyshev_t(jnp.asarray(0.5), -1)
    with pytest.raises(ValueError):
        check_weight_magnitudes(np.array([1.5, 0.5, 0.5, 0.5]))
    # In-range passes through
    check_unit_interval(np.array([-1.0, 1.0, 0.0]))
    check_weight_magnitudes(np.array([1.0, -1.0]))


def test_cumulative_transform_layout():
    # [T_0(x_0)..T_D(x_0), T_0(x_1)..T_D(x_1), ...] per row
    # (reference KAN_w_cumulative_polynomials.py:56-70)
    x = np.array([[0.5, -0.25]])
    out = np.asarray(cumulative_transform(jnp.asarray(x), 2))
    expected = []
    for v in [0.5, -0.25]:
        expected += [1.0, v, 2 * v**2 - 1]
    np.testing.assert_allclose(out[0], expected, atol=1e-12)
