"""LCU power-of-two stress sweep (reference LCUStep.py:109-161).

The reference's largest quantum systems: {N,K,d} up to N*K = 32 with degree
20 -- an 11-qubit block-encoding circuit.  Each configuration must satisfy
the 1e-6 relative-Frobenius contract through the statevector engine, with
the reference-style stage-timing breakdown exercised via StageTimer.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from qkan_implementation.encoding import fable
from qkan_implementation.ops import lcu_combine_diag
from qkan_implementation.sim import unitary
from qkan_implementation.utils.profiling import StageTimer


@pytest.mark.parametrize(
    "N,K,d,name",
    [
        (4, 4, 5, "4x4 Basic Power-2"),
        (4, 8, 8, "4x8 Wide Power-2"),
        (8, 4, 7, "8x4 Tall Power-2"),
        (4, 8, 20, "4x8 High Degree"),
    ],
)
def test_power_of_two_systems(N, K, d, name):
    rng = np.random.default_rng(42)
    timer = StageTimer(annotate_trace=False)

    with timer.stage("weights"):
        x = rng.uniform(-1, 1, size=N)
        weights = rng.uniform(-1, 1, size=(d + 1, N * K))

    with timer.stage("matrix"):
        diag = np.asarray(
            lcu_combine_diag(jnp.asarray(x), jnp.asarray(weights), K)
        )
        expected = np.diag(diag)

    with timer.stage("circuit"):
        circ, scale = fable(expected)

    with timer.stage("verify"):
        u = np.asarray(unitary(circ))
        block = N * K
        actual = u[:block, :block] * scale * block
        diff = np.linalg.norm(actual - expected) / np.linalg.norm(expected)

    report = timer.report(memory_bytes=expected.nbytes)
    assert "verify" in report and "Memory footprint" in report
    assert diff < 1e-6, f"{name}: relative difference too high: {diff}"


@pytest.mark.parametrize(
    "case",
    ["boundary_inputs", "alternating_weights", "small_weights", "identical_weights"],
)
def test_edge_cases(case):
    # reference LCUStep.py:163-211 edge cases at the 1e-6 contract
    N, K, d = 4, 4, 2
    rng = np.random.default_rng(42)
    if case == "boundary_inputs":
        x = np.array([-1.0] * (N // 2) + [1.0] * (N // 2))
        weights = rng.uniform(-1, 1, (d + 1, N * K))
    elif case == "alternating_weights":
        x = rng.uniform(-1, 1, N)
        weights = np.tile(np.array([1.0, -1.0] * (N * K // 2)), (d + 1, 1))
    elif case == "small_weights":
        x = rng.uniform(-1, 1, N)
        weights = rng.uniform(-0.01, 0.01, (d + 1, N * K))
    else:
        x = rng.uniform(-1, 1, N)
        weights = np.full((d + 1, N * K), 0.5)

    diag = np.asarray(lcu_combine_diag(jnp.asarray(x), jnp.asarray(weights), K))
    expected = np.diag(diag)
    circ, scale = fable(expected)
    u = np.asarray(unitary(circ))
    actual = u[: N * K, : N * K] * scale * N * K
    denom = np.linalg.norm(expected)
    if denom < 1e-30:
        assert np.linalg.norm(actual) < 1e-8
    else:
        assert np.linalg.norm(actual - expected) / denom < 1e-6
