"""Symbolic QUBO builder tests, incl. cross-validation against the analytic
degree-selection assembly (the two must produce identical energies)."""

import numpy as np
import pytest

from qkan_implementation.anneal import degree_selection_qubo
from qkan_implementation.anneal.expr import (
    Array,
    Binary,
    Constraint,
    QuboExpr,
)


def test_basic_arithmetic_and_idempotence():
    x, y = Binary("x"), Binary("y")
    e = 2 * x + 3 * y - 1
    assert e.energy({"x": 1, "y": 0}) == 1.0
    assert e.energy({"x": 1, "y": 1}) == 4.0
    # x*x = x
    sq = x * x
    assert sq.energy({"x": 1}) == 1.0
    assert (x**2).energy({"x": 1}) == 1.0
    # (x + y - 1)^2 expands with idempotence
    c = (x + y - 1) ** 2
    for xv in (0, 1):
        for yv in (0, 1):
            assert c.energy({"x": xv, "y": yv}) == (xv + yv - 1) ** 2


def test_degree_gt_2_raises_at_compile():
    x, y, z = Binary("x"), Binary("y"), Binary("z")
    cubic = x * y * z
    with pytest.raises(ValueError):
        cubic.compile()


def test_array_create_shapes():
    q = Array.create("q", shape=(2, 3), vartype="BINARY")
    assert q.shape == (2, 3)
    assert q[1, 2].variables() == ["q[1][2]"]
    with pytest.raises(ValueError):
        Array.create("s", shape=2, vartype="SPIN")


def test_compile_and_energy_match():
    x, y = Binary("x"), Binary("y")
    H = 2 * x - y + 4 * x * y + 0.5
    model = H.compile().to_qubo_model()
    for xv in (0, 1):
        for yv in (0, 1):
            s = np.array([xv, yv], dtype=float)  # sorted order: x, y
            np.testing.assert_allclose(
                model.energy(s), H.energy({"x": xv, "y": yv}), atol=1e-12
            )


def test_constraint_tracking():
    q = Array.create("q", shape=(3,))
    H = sum((-0.5 * q[i] for i in range(3)), QuboExpr.constant(0.0))
    H = H + 10.0 * Constraint((sum(q[i] for i in range(3)) - 1) ** 2, label="one_hot")
    compiled = H.compile()
    good = compiled.decode_sample(np.array([0, 1, 0]))
    assert good.constraint_satisfied("one_hot")
    bad = compiled.decode_sample(np.array([1, 1, 0]))
    assert not bad.constraint_satisfied("one_hot")
    assert bad.broken_constraints["one_hot"] == 1.0


def test_symbolic_matches_analytic_degree_qubo():
    # Build the reference Hamiltonian symbolically, exactly as
    # DegreeOptimizer.optimize_layer does (reference :211-230), and compare
    # energies with the analytic assembly over random assignments.
    scores = np.array([0.7, 0.32, 0.28, 0.27])
    num_functions, dp1 = 3, 4
    cw = 0.1

    q = Array.create("q", shape=(num_functions, dp1))
    H = QuboExpr.constant(0.0)
    for i in range(num_functions):
        for d in range(dp1):
            improvement = scores[d] - scores[d - 1] if d > 0 else scores[d]
            H = H + (-1.0 * improvement) * q[i, d]
            H = H + cw * (d**2) * q[i, d]
    for i in range(num_functions):
        constraint = (sum(q[i, d] for d in range(dp1)) - 1) ** 2
        H = H + 10.0 * Constraint(constraint, label=f"one_degree_{i}")

    symbolic = H.compile().to_qubo_model()
    analytic = degree_selection_qubo(scores, num_functions, complexity_weight=cw)

    rng = np.random.default_rng(0)
    for _ in range(50):
        s = rng.integers(0, 2, num_functions * dp1).astype(float)
        # variable order: q[0][0], q[0][1], ... lexicographic == analytic layout
        np.testing.assert_allclose(
            symbolic.energy(s), analytic.energy(s), atol=1e-10
        )


def test_solve_via_annealer():
    q = Array.create("q", shape=(4,))
    # minimize: pick exactly the variable with most negative bias
    H = (
        -1.0 * q[0]
        - 3.0 * q[1]
        - 2.0 * q[2]
        - 0.5 * q[3]
        + 10.0 * Constraint((sum(q[i] for i in range(4)) - 1) ** 2, "one")
    )
    best = H.compile().solve(num_reads=64, num_sweeps=200, seed=0)
    assert best.sample == {"q[0]": 0, "q[1]": 1, "q[2]": 0, "q[3]": 0}
    assert best.constraint_satisfied("one")


def test_power_does_not_duplicate_constraints():
    """Regression: e * e concatenated both operands' constraint lists, so
    (Constraint(expr) ** n) carried n copies and decode_sample evaluated
    each constraint n times."""
    x = Binary("x")
    y = Binary("y")
    c = Constraint(x + y - 1, label="one")
    h = (c ** 2) + c * c
    assert len(h.constraints) == 1
    model = h.compile()
    dec = model.decode_sample(np.array([1, 0]))
    assert dec.broken_constraints == {}


def test_decode_sampleset_uses_given_energies():
    x = Binary("x")
    model = (2.0 * x).compile()
    samples = np.array([[1], [0]])
    decs = model.decode_sampleset(samples, energies=np.array([123.0, 7.0]))
    assert decs[0].energy == 123.0 and decs[1].energy == 7.0
