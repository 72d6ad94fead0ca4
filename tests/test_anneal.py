"""Tests for QUBO assembly + the on-device simulated annealer.

The correctness bar: on the degree-selection QUBOs the reference solves with
neal (``DegreeOptimizer.py:211-237``), the annealer must find the exact
optimum (verifiable by brute force / block-wise argmin).
"""

import numpy as np
import pytest

from qkan_implementation.anneal import (
    QuboModel,
    decode_degrees,
    default_beta_range,
    degree_selection_qubo,
    simulated_annealing,
    solve_qubo,
)


def brute_force_min(model: QuboModel):
    """Vectorized exact optimum -- fine up to ~n=20 (2^20 x n floats).

    Used as the UNCONDITIONAL ground-truth oracle: the optimality
    assertions below must not silently vanish on hosts without the C++
    toolchain (the old native_available() gating left tautologies)."""
    n = model.num_variables
    states = (
        (np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1
    ).astype(np.float64)
    e = model.energy(states)
    i = int(np.argmin(e))
    return states[i], float(e[i])


def test_energy_convention():
    # E = offset + h.s + sum_{i<j} J_ij s_i s_j
    h = np.array([1.0, -2.0])
    J = np.array([[0.0, 3.0], [3.0, 0.0]])
    m = QuboModel(h=h, J=J, offset=0.5)
    assert m.energy(np.array([0, 0])) == 0.5
    assert m.energy(np.array([1, 0])) == 1.5
    assert m.energy(np.array([1, 1])) == 0.5 + 1 - 2 + 3
    # batch
    np.testing.assert_allclose(
        m.energy(np.array([[0, 0], [1, 1]])), [0.5, 2.5]
    )


def test_degree_qubo_matches_symbolic_expansion():
    # Expand H = sum_i [ -imp_d q_id + cw d^2 q_id ] + 10 (sum_d q_id - 1)^2
    # by brute force over a small instance and compare energies.
    scores = np.array([0.9, 0.3, 0.25])
    model = degree_selection_qubo(scores, num_functions=2, complexity_weight=0.1)

    def reference_energy(q):  # q shape [2, 3]
        H = 0.0
        imp = [scores[0], scores[1] - scores[0], scores[2] - scores[1]]
        for i in range(2):
            for d in range(3):
                H += -1.0 * imp[d] * q[i, d]
                H += 0.1 * d**2 * q[i, d]
            H += 10.0 * (q[i].sum() - 1) ** 2
        return H

    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.integers(0, 2, (2, 3)).astype(np.float64)
        np.testing.assert_allclose(
            model.energy(q.reshape(-1)), reference_energy(q), atol=1e-10
        )


def test_definitive_qubo():
    scores = np.array([0.5, 0.1, 0.4])
    model = degree_selection_qubo(
        scores, num_functions=1, definitive_degree=1
    )
    s_good = np.array([0.0, 1.0, 0.0])
    s_bad = np.array([1.0, 0.0, 0.0])
    assert model.energy(s_good) < model.energy(s_bad)


def test_annealer_finds_brute_force_optimum_small():
    scores = np.array([0.9, 0.3, 0.25])
    model = degree_selection_qubo(scores, num_functions=2, complexity_weight=0.1)
    expected_s, expected_e = brute_force_min(model)

    sample, energy = solve_qubo(model, num_reads=64, num_sweeps=200, seed=1)
    np.testing.assert_allclose(energy, expected_e, atol=1e-5)
    np.testing.assert_array_equal(sample, expected_s)


def test_annealer_on_random_qubo():
    rng = np.random.default_rng(3)
    n = 10
    J = rng.normal(size=(n, n))
    J = (J + J.T) / 2
    np.fill_diagonal(J, 0.0)
    h = rng.normal(size=n)
    model = QuboModel(h=h, J=J, offset=0.0)
    _, expected_e = brute_force_min(model)
    _, energy = solve_qubo(model, num_reads=256, num_sweeps=300, seed=2)
    np.testing.assert_allclose(energy, expected_e, atol=1e-4)


def test_larger_degree_qubo_is_one_hot_and_optimal():
    # 8 functions x degrees 0..3: per-function blocks are independent, so the
    # exact optimum is the blockwise one-hot argmin.
    scores = np.array([0.8, 0.35, 0.3, 0.29])
    nf, dp1 = 8, 4
    model = degree_selection_qubo(scores, num_functions=nf, complexity_weight=0.1)

    # exact blockwise optimum
    imp = np.array([scores[0], *(scores[1:] - scores[:-1])])
    lin = -imp + 0.1 * np.arange(dp1) ** 2
    best_d = int(np.argmin(lin))

    sample, energy = solve_qubo(
        model, num_reads=128, num_sweeps=500, seed=4, one_hot_block_size=dp1
    )
    q = sample.reshape(nf, dp1)
    assert np.all(q.sum(axis=1) == 1), "one-hot constraint violated"
    assert np.all(q[:, best_d] == 1)

    expected_e = nf * (lin[best_d])  # one-hot terms cancel offset
    np.testing.assert_allclose(energy, expected_e, atol=1e-4)

    # WITHOUT the one-hot polish (which computes the blockwise argmin in
    # closed form and would repair even a broken annealer): the raw
    # Metropolis chains must find the optimum themselves at the
    # reference's own budget (num_reads=1000, DegreeOptimizer.py:236-237;
    # 128 reads is below the single-flip barrier-crossing budget for
    # one-hot penalties -- measured -3.9 vs -6.4)
    _, energy_raw = solve_qubo(
        model, num_reads=1000, num_sweeps=1000, seed=4,
        one_hot_block_size=None,
    )
    np.testing.assert_allclose(energy_raw, expected_e, atol=1e-4)


def test_decode_degrees_layout():
    # function index out*input_dim + in (reference DegreeOptimizer.py:242-254)
    input_dim, output_dim, max_degree = 2, 2, 2
    sample = np.zeros((4, 3))
    sample[0, 1] = 1  # out0,in0 -> degree 1
    sample[1, 2] = 1  # out0,in1 -> degree 2
    sample[2, 0] = 1  # out1,in0 -> degree 0
    sample[3, 1] = 1  # out1,in1 -> degree 1
    degrees = decode_degrees(sample.reshape(-1), input_dim, output_dim, max_degree)
    assert degrees == [[1, 2], [0, 1]]


def test_beta_range_sane():
    scores = np.array([0.9, 0.3])
    model = degree_selection_qubo(scores, num_functions=3)
    hot, cold = default_beta_range(model)
    assert 0 < hot < cold


def test_reproducible_with_seed():
    scores = np.array([0.9, 0.3, 0.25])
    model = degree_selection_qubo(scores, num_functions=2)
    s1, e1 = simulated_annealing(model, num_reads=16, num_sweeps=50, seed=7)
    s2, e2 = simulated_annealing(model, num_reads=16, num_sweeps=50, seed=7)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(e1, e2)


def test_blocked_kernel_matches_full_on_degree_qubo():
    # Block-diagonal fast path: same optimum as the general kernel.  Raw
    # single-flip minima on a one-hot QUBO are a min-of-R statistic with
    # per-chain ground-state probability ~1e-3 (Metropolis must tunnel the
    # penalty barrier), so the paths are compared the way production uses
    # them: through the blockwise one-hot polish, which is deterministic
    # and globally optimal for this separable problem.
    from qkan_implementation.anneal import polish_one_hot_blocks

    scores = np.array([0.29, 0.13, 0.056, 0.054])
    model = degree_selection_qubo(scores, num_functions=6, complexity_weight=0.1)
    s_full, e_full = simulated_annealing(
        model, num_reads=128, num_sweeps=300, seed=0
    )
    s_blk, e_blk = simulated_annealing(
        model, num_reads=128, num_sweeps=300, seed=0, block_structure=4
    )
    e_full_p = model.energy(polish_one_hot_blocks(model, s_full, 4))
    e_blk_p = model.energy(polish_one_hot_blocks(model, s_blk, 4))
    assert abs(e_full_p.min() - e_blk_p.min()) < 1e-9
    # energies consistent with samples in both raw paths
    np.testing.assert_allclose(e_blk, model.energy(s_blk), atol=1e-4)
    np.testing.assert_allclose(e_full, model.energy(s_full), atol=1e-4)


def test_block_structure_falls_back_when_not_block_diagonal():
    rng = np.random.default_rng(0)
    n = 8
    J = rng.normal(size=(n, n)); J = (J + J.T) / 2; np.fill_diagonal(J, 0)
    model = QuboModel(h=rng.normal(size=n), J=J, offset=0.0)
    # block_structure=4 requested but couplings cross blocks: falls back
    s, e = simulated_annealing(
        model, num_reads=32, num_sweeps=100, seed=0, block_structure=4
    )
    np.testing.assert_allclose(e, model.energy(s), atol=1e-4)


def test_tempering_beta_range_is_median_anchored():
    """The tempering LADDER default must not inherit SA's min-scale cold
    end: one tiny coupling sends ``default_beta_range``'s cold end to
    log(100)/min (useless ladder span -- adjacent rungs never exchange,
    the r5 n=2048 head-to-head regression), while the ladder default
    anchors to the MEDIAN coupling scale."""
    from qkan_implementation.anneal import default_tempering_beta_range

    rng = np.random.default_rng(5)
    n = 64
    J = rng.normal(0, 1, (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    h = rng.normal(0, 1, n)
    h[0] = 1e-7  # one tiny bias: min-scale cold end explodes to ~4.6e7
    model = QuboModel(h=h, J=J, offset=0.0)
    hot_sa, cold_sa = default_beta_range(model)
    hot_pt, cold_pt = default_tempering_beta_range(model)
    assert hot_pt == hot_sa  # same hot end (accept the largest |dE|)
    assert cold_sa > 1e6  # SA's schedule may resolve the finest scale
    entries = np.concatenate([np.abs(h), np.abs(J).ravel()])
    med = np.median(entries[entries > 1e-12])  # zero J diagonal excluded
    assert cold_pt == pytest.approx(np.log(100.0) / med)
    assert cold_pt < 100.0  # a 16-rung ladder can actually span this


class TestParallelTempering:
    def test_finds_ground_state_dense_qubo(self):
        # dense non-separable Gaussian couplings, verified vs brute force
        from qkan_implementation.anneal import parallel_tempering
        from qkan_implementation.native_bindings import (
            brute_force_native,
            native_available,
        )

        rng = np.random.default_rng(3)
        n = 16
        J = rng.normal(0, 1, (n, n))
        J = J + J.T
        np.fill_diagonal(J, 0.0)
        h = rng.normal(0, 1, n)
        model = QuboModel(h=h, J=J, offset=0.5)
        samples, energies = parallel_tempering(
            model, num_chains=16, num_replicas=8, num_sweeps=200, seed=0
        )
        assert samples.shape == (16 * 8, n)
        # returned energies match recomputation (offset included)
        np.testing.assert_allclose(
            energies, model.energy(samples), atol=1e-4
        )
        _, truth = brute_force_min(model)
        assert energies.min() <= truth + 1e-4
        if native_available():  # C++ oracle agrees with the numpy one
            _, truth_native = brute_force_native(model)
            np.testing.assert_allclose(truth_native, truth, atol=1e-9)

    def test_not_worse_than_plain_sa_small_budget(self):
        # same chain budget, frustrated instance: exchanges must not hurt
        from qkan_implementation.anneal import (
            parallel_tempering,
            simulated_annealing,
        )

        rng = np.random.default_rng(11)
        n = 48
        J = rng.normal(0, 1, (n, n))
        J = J + J.T
        np.fill_diagonal(J, 0.0)
        h = rng.normal(0, 0.1, n)
        model = QuboModel(h=h, J=J, offset=0.0)
        _, e_pt = parallel_tempering(
            model, num_chains=8, num_replicas=8, num_sweeps=150, seed=1
        )
        _, e_sa = simulated_annealing(
            model, num_reads=64, num_sweeps=150, seed=1
        )
        assert e_pt.min() <= e_sa.min() + 0.3


def test_greedy_descent_reaches_local_optimum():
    from qkan_implementation.anneal import greedy_descent, simulated_annealing
    from qkan_implementation.native_bindings import (
        brute_force_native,
        native_available,
    )

    rng = np.random.default_rng(7)
    n = 18
    J = rng.normal(0, 1 / np.sqrt(n), (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    h = rng.normal(0, 1, n)
    model = QuboModel(h=h, J=J, offset=0.0)
    samples, energies = simulated_annealing(
        model, num_reads=64, num_sweeps=60, seed=0
    )
    polished = greedy_descent(model, samples)
    ep = model.energy(polished)
    assert ep.min() <= energies.min() + 1e-9
    # every polished sample is a single-flip local optimum
    best = polished[np.argmin(ep)]
    f = model.h + model.J @ best
    de = (1.0 - 2.0 * best) * f
    assert np.all(de >= -1e-9)
    _, truth = brute_force_min(model)
    assert ep.min() <= truth + 1e-6


def test_parallel_tempering_sharded_matches_quality():
    import jax
    from qkan_implementation.parallel import make_mesh
    from qkan_implementation.anneal import parallel_tempering_sharded
    from qkan_implementation.native_bindings import (
        brute_force_native,
        native_available,
    )

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(8, axis_name="d")
    rng = np.random.default_rng(5)
    n = 16
    J = rng.normal(0, 1, (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    h = rng.normal(0, 1, n)
    model = QuboModel(h=h, J=J, offset=0.0)
    samples, energies = parallel_tempering_sharded(
        mesh=mesh, model=model, num_chains=16, num_replicas=4,
        num_sweeps=150, seed=0,
    )
    assert samples.shape[0] == 16 * 4  # ceil(16/8)*8 chains x 4 replicas
    np.testing.assert_allclose(energies, model.energy(samples), atol=1e-3)
    _, truth = brute_force_min(model)
    assert energies.min() <= truth + 1e-3


def test_parallel_tempering_mesh_ladder():
    """One global ladder split across the mesh: boundary replicas exchange
    over the mesh; quality must match the local-ladder tempering on the same
    dense frustrated instance, and energies must be self-consistent."""
    import jax
    from qkan_implementation.parallel import make_mesh
    from qkan_implementation.anneal import parallel_tempering_mesh_ladder
    from qkan_implementation.native_bindings import (
        brute_force_native,
        native_available,
    )

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(8, axis_name="d")
    rng = np.random.default_rng(13)
    n = 16
    J = rng.normal(0, 1, (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    h = rng.normal(0, 1, n)
    model = QuboModel(h=h, J=J, offset=0.25)
    samples, energies = parallel_tempering_mesh_ladder(
        model, mesh=mesh, num_chains=8, num_replicas=16, num_sweeps=200,
        seed=0,
    )
    assert samples.shape == (8 * 16, n)
    np.testing.assert_allclose(energies, model.energy(samples), atol=1e-3)
    _, truth = brute_force_min(model)
    assert energies.min() <= truth + 1e-4


def test_mesh_ladder_requires_divisible_replicas():
    import jax
    import pytest
    from qkan_implementation.parallel import make_mesh
    from qkan_implementation.anneal import parallel_tempering_mesh_ladder

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(8, axis_name="d")
    model = QuboModel(h=np.zeros(4), J=np.zeros((4, 4)), offset=0.0)
    with pytest.raises(ValueError):
        parallel_tempering_mesh_ladder(model, mesh=mesh, num_replicas=12)


def test_annealer_oracle_sweep_random_dense_qubos():
    """Deterministic mini-sweep: on 10 random dense n=8 QUBOs (256 states,
    exact oracle vectorized), the annealer at a modest budget must hit the
    global optimum on every instance -- a distributional guard the single
    hand-picked instances can't give."""
    from qkan_implementation.anneal import solve_qubo

    rng = np.random.default_rng(99)
    for trial in range(10):
        n = 8
        J = rng.normal(0, 1, (n, n))
        J = J + J.T
        np.fill_diagonal(J, 0.0)
        h = rng.normal(0, 1, n)
        model = QuboModel(h=h, J=J, offset=float(rng.normal()))
        _, truth = brute_force_min(model)
        _, energy = solve_qubo(
            model, num_reads=64, num_sweeps=300, seed=trial
        )
        # tolerance covers the on-device f32 energy accumulation vs the
        # f64 oracle (same state, ~1e-6 energy gap), not search slack
        assert energy <= truth + 1e-5, (trial, energy, truth)


def test_sharded_annealing_multi_axis_mesh():
    """Regression: n_dev was the product of ALL mesh axes while chains
    shard over axis_name only -- a 2-axis mesh silently returned a quarter
    of the requested reads.  The sharded axis size alone must govern."""
    import jax
    from qkan_implementation.anneal import simulated_annealing_sharded
    from jax.sharding import Mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 CPU devices")
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("x", "y"))
    scores = np.array([0.8, 0.35, 0.3, 0.29])
    model = degree_selection_qubo(scores, num_functions=2, complexity_weight=0.1)
    samples, energies = simulated_annealing_sharded(
        model, mesh, axis_name="y", num_reads=16, num_sweeps=100, seed=0
    )
    assert samples.shape[0] >= 16, samples.shape
    np.testing.assert_allclose(energies, model.energy(samples), atol=1e-4)


def test_delayed_kernel_block_size_invariance():
    """The delayed-update dense kernel is a SCHEDULE change, not an
    algorithm change: with the same key, any sweep_block produces the
    identical Markov chain (same uniforms consumed in the same variable
    order; field sums differ only by fp reassociation, nulled at x64)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    n = 24
    J = rng.normal(0, 1 / np.sqrt(n), (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    model = QuboModel(h=rng.normal(0, 1, n), J=J, offset=0.0)
    ref_s, ref_e = simulated_annealing(
        model, num_reads=16, num_sweeps=120, seed=3,
        dtype=jnp.float64, sweep_block=1,
    )
    for blk in (2, 8, 16, 24):  # 16 pads n=24 -> 32: exercises padding
        s, e = simulated_annealing(
            model, num_reads=16, num_sweeps=120, seed=3,
            dtype=jnp.float64, sweep_block=blk,
        )
        np.testing.assert_array_equal(s, ref_s)
        np.testing.assert_allclose(e, ref_e, atol=1e-9)
    # padding variables must not leak into samples or energies
    assert ref_s.shape == (16, n)
    np.testing.assert_allclose(ref_e, model.energy(ref_s), atol=1e-9)


def test_delayed_kernel_quality_matches_sequential_reference():
    """The retired per-variable kernel stays as the reference
    implementation: both samplers must reach the brute-force ground state
    on a dense 18-var QUBO with the same read/sweep budget."""
    import jax
    import jax.numpy as jnp
    from qkan_implementation.anneal.sa import (
        _anneal_kernel,
        default_beta_range,
    )

    rng = np.random.default_rng(11)
    n = 18
    J = rng.normal(0, 1 / np.sqrt(n), (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    model = QuboModel(h=rng.normal(0, 1, n), J=J, offset=0.0)
    truth = brute_force_min(model)[1]
    s_new, e_new = simulated_annealing(
        model, num_reads=256, num_sweeps=400, seed=2
    )
    lo, hi = default_beta_range(model)
    betas = jnp.asarray(np.geomspace(lo, hi, 400), dtype=jnp.float32)
    _, e_old = _anneal_kernel(
        jnp.asarray(model.h, dtype=jnp.float32),
        jnp.asarray(model.J, dtype=jnp.float32),
        betas, jax.random.key(2), 256, 400,
    )
    assert e_new.min() <= truth + 1e-5
    assert float(np.min(np.asarray(e_old))) <= truth + 1e-5


def test_delayed_tempering_matches_reference_kernel_quality():
    """The delayed-update tempering kernel and the
    per-variable reference kernel must both reach the brute-force ground
    state on a dense QUBO, with energies consistent with samples."""
    from qkan_implementation.anneal import parallel_tempering
    from qkan_implementation.native_bindings import (
        brute_force_native,
        native_available,
    )

    rng = np.random.default_rng(3)
    n = 18
    J = rng.normal(0, 1 / np.sqrt(n), (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    model = QuboModel(h=rng.normal(0, 1, n), J=J, offset=0.25)
    mins = {}
    for kern in ("delayed", "reference"):
        s, e = parallel_tempering(
            model, num_chains=16, num_replicas=8, num_sweeps=300,
            seed=1, kernel=kern,
        )
        np.testing.assert_allclose(e, model.energy(s), atol=1e-4)
        mins[kern] = e.min()
    assert abs(mins["delayed"] - mins["reference"]) < 1e-4
    if native_available():
        truth = brute_force_native(model)[1]
        assert mins["delayed"] <= truth + 1e-5

def test_unknown_kernel_and_backend_raise():
    """Typos must not silently select a different sampler (review r3):
    parallel_tempering(kernel=...) and simulated_annealing(backend=...)
    validate their enum-ish strings like every other new param."""
    import pytest
    from qkan_implementation.anneal.sa import parallel_tempering

    rng = np.random.default_rng(0)
    n = 6
    J = rng.normal(0, 1, (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    model = QuboModel(h=rng.normal(0, 1, n), J=J, offset=0.0)
    with pytest.raises(ValueError, match="unknown kernel"):
        parallel_tempering(model, num_chains=2, num_replicas=2,
                           num_sweeps=2, kernel="refernce")
    with pytest.raises(ValueError, match="unknown backend"):
        simulated_annealing(model, num_reads=2, num_sweeps=2,
                            backend="natve")


def test_sweep_block_validation():
    """sweep_block=0 / negative / non-int must raise a clear ValueError,
    not ZeroDivisionError or a deep reshape error (review r3); an explicit
    valid block still produces the block-invariant result."""
    import pytest
    from qkan_implementation.anneal.sa import parallel_tempering

    rng = np.random.default_rng(1)
    n = 8
    J = rng.normal(0, 1, (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    model = QuboModel(h=rng.normal(0, 1, n), J=J, offset=0.0)
    for bad in (0, -8, 2.5):
        with pytest.raises(ValueError, match="sweep_block"):
            simulated_annealing(
                model, num_reads=2, num_sweeps=2, sweep_block=bad
            )
        with pytest.raises(ValueError, match="sweep_block"):
            parallel_tempering(
                model, num_chains=2, num_replicas=2, num_sweeps=2,
                sweep_block=bad,
            )
    s, e = simulated_annealing(
        model, num_reads=4, num_sweeps=20, sweep_block=4, seed=3
    )
    assert s.shape == (4, n) and np.isfinite(e).all()
