"""FABLE block-encoding golden tests.

Replicates the reference's verification contract exactly: simulate the
circuit's unitary, extract the top-left block, rescale by alpha*N, and compare
to the encoded matrix -- relative Frobenius error < 1e-6 with structure match
(reference ``MulStep.py:115-166``), and < 1e-15 for the dilated Chebyshev case
(reference ``ChebyshevStep.py:117-134``).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from qkan_implementation.encoding import fable, gray_code, gray_permutation, sfwht
from qkan_implementation.sim import unitary


def verify_block_encoding(a, tol=1e-6, check_structure=True, **fable_kwargs):
    """Mirror of the reference's ``verify_unitary`` helper (MulStep.py:115-166)."""
    a = np.asarray(a, dtype=np.float64)
    circ, alpha = fable(a, **fable_kwargs)
    u = np.asarray(unitary(circ))
    block = a.shape[0]
    actual = u[:block, :block] * alpha * block

    if np.allclose(a, 0):
        diff = np.linalg.norm(actual - a)
    else:
        diff = np.linalg.norm(actual - a) / np.linalg.norm(a)
    assert diff < tol, f"Relative difference too high: {diff}"

    if check_structure:
        expected_pattern = np.abs(a) > 1e-10
        actual_pattern = np.abs(actual) > 1e-10
        assert np.array_equal(expected_pattern, actual_pattern), (
            "Matrix structure does not match expected pattern"
        )
    # And the full operator must be unitary
    np.testing.assert_allclose(u @ u.T.conj(), np.eye(u.shape[0]), atol=1e-9)
    return diff


def test_gray_code_helpers():
    assert [gray_code(i) for i in range(8)] == [0, 1, 3, 2, 6, 7, 5, 4]
    a = np.arange(8.0)
    assert gray_permutation(a).tolist() == [0, 1, 3, 2, 6, 7, 5, 4]
    # sfwht is (1/2^k) * Hadamard transform
    rng = np.random.default_rng(0)
    v = rng.normal(size=8)
    hmat = np.array([[1.0]])
    for _ in range(3):
        hmat = np.kron(np.array([[1, 1], [1, -1]]), hmat)
    np.testing.assert_allclose(sfwht(v), hmat @ v / 8.0, atol=1e-12)


@pytest.mark.parametrize("fused", [True, False])
def test_diagonal_2x2(fused):
    verify_block_encoding(np.diag([0.5, -0.5]), tol=1e-12, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_dense_2x2(fused):
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (2, 2))
    verify_block_encoding(a, tol=1e-12, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_dense_4x4_nonsymmetric(fused):
    # Non-symmetric pins the row/column orientation of the encoding.
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (4, 4))
    a[0, 1] = 0.9
    a[1, 0] = -0.1
    verify_block_encoding(a, tol=1e-10, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
def test_dilated_chebyshev_1e15(fused):
    # The reference's tightest tolerance: dilated Chebyshev diag, N=4, deg 8,
    # relative error < 1e-15 (ChebyshevStep.py:117-134).  Met exactly on the
    # x64 suite (measured floor ~5e-16 fused / ~6e-16 elementary).
    from qkan_implementation.ops import dilated_chebyshev_diag

    rng = np.random.default_rng(42)
    x = rng.uniform(-1, 1, 4)
    diag = np.asarray(dilated_chebyshev_diag(jnp.asarray(x), K=1, degree=8))
    a = np.diag(diag)
    diff = verify_block_encoding(a, tol=1e-15, fused=fused)
    assert diff < 1e-15


def test_alpha_rescaling_for_large_entries():
    a = np.array([[2.0, 0.0], [0.0, -3.0]])
    circ, alpha = fable(a)
    assert alpha > 3.0
    verify_block_encoding_scaled = np.asarray(unitary(circ))[:2, :2] * alpha * 2
    np.testing.assert_allclose(verify_block_encoding_scaled, a, atol=1e-8)


def test_zero_matrix():
    verify_block_encoding(np.zeros((2, 2)), tol=1e-10, check_structure=False)


def test_padding_non_square():
    a = np.array([[0.3, -0.2, 0.1]])  # 1x3 -> padded to 4x4
    circ, alpha = fable(a)
    u = np.asarray(unitary(circ))
    padded = np.zeros((4, 4))
    padded[:1, :3] = a
    np.testing.assert_allclose(u[:4, :4] * alpha * 4, padded, atol=1e-10)


def test_fused_equals_elementary():
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (4, 4))
    cf, alpha_f = fable(a, fused=True)
    ce, alpha_e = fable(a, fused=False)
    assert alpha_f == alpha_e
    np.testing.assert_allclose(
        np.asarray(unitary(cf)), np.asarray(unitary(ce)), atol=1e-10
    )


def test_compression_drops_gates():
    # A uniform matrix has a single nonzero Walsh-Hadamard coefficient, so
    # compression collapses the 2*4^n ladder to O(1) rotations.
    a = np.full((4, 4), 0.3)
    # threshold < 0 keeps even exactly-zero rotations (the |phi| > threshold
    # drop matches the reference's fable(A, 0) cutoff semantics).
    uncompressed = len(fable(a, compression_threshold=-1.0, fused=False)[0].gates)
    compressed_circ, _ = fable(a, compression_threshold=1e-8, fused=False)
    assert len(compressed_circ.gates) < uncompressed
    verify_block_encoding(a, tol=1e-8, fused=False, compression_threshold=1e-12)


def test_weighted_chebyshev_block_encoding():
    # Reference MulStep test: degree-1 weighted Chebyshev, N=K=2
    # (MulStep.py:190-213).
    from qkan_implementation.ops import weighted_chebyshev_diag

    x = jnp.asarray([0.5, -0.5])
    weights = jnp.asarray([1.0, 0.5, -0.5, -1.0])
    diag = np.asarray(weighted_chebyshev_diag(x, weights, K=2, degree=1))
    expected_diag = np.array([0.5, 0.5, -0.5, -0.5]) * np.asarray(weights)
    np.testing.assert_allclose(diag, expected_diag, atol=1e-12)
    verify_block_encoding(np.diag(diag), tol=1e-6)


def test_lcu_block_encoding_power_of_two():
    # Reference LCU sweep shape {N=4, K=4, d=5} (LCUStep.py:109-161), at the
    # 1e-6 contract.
    from qkan_implementation.ops import lcu_combine_diag

    rng = np.random.default_rng(42)
    N, K, d = 4, 4, 5
    x = rng.uniform(-1, 1, N)
    w = rng.uniform(-1, 1, (d + 1, N * K))
    diag = np.asarray(lcu_combine_diag(jnp.asarray(x), jnp.asarray(w), K))
    verify_block_encoding(np.diag(diag), tol=1e-6)


def test_sum_step_block_encoding():
    # Reference SUMStep simple case (SUMStep.py:80-102): K x K output diag.
    from qkan_implementation.ops import sum_step

    N = K = 2
    input_vals = jnp.asarray([1.0, 0.5, -0.5, -1.0])
    out = np.asarray(sum_step(input_vals, N, K))
    np.testing.assert_allclose(out, [0.75, -0.75], atol=1e-12)
    verify_block_encoding(np.diag(out), tol=1e-6)


def test_runtime_params_rejects_complex():
    """Regression: fable() rejects complex matrices but
    fable_runtime_params silently dropped the imaginary part and encoded
    Re(a)."""
    from qkan_implementation.encoding.fable import fable_runtime_params

    a = np.eye(4) + 1j * np.ones((4, 4))
    with pytest.raises(ValueError, match="real"):
        fable_runtime_params(a)


def test_fused_rejects_compression_threshold():
    """The fused gate carries every rotation: asking for the reference's
    approximate compression with fused=True must be an error, not a
    silently-uncompressed encoding."""
    with pytest.raises(ValueError, match="compression"):
        fable(np.eye(4), 1e-2, fused=True)
