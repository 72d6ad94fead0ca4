"""Remaining reference test scenarios (fixed_kan_tests.py,
Tests_TorchDegreeOptimizer.py) ported to the JAX build."""

import numpy as np
import pandas as pd
import pytest
import jax
import jax.numpy as jnp

from qkan_implementation.anneal import degree_selection_qubo
from qkan_implementation.anneal.sa import simulated_annealing_sharded
from qkan_implementation.models import FixedKAN, FixedKANConfig
from qkan_implementation.optim import DegreeOptimizer
from qkan_implementation.parallel import make_mesh


def _working_config(shape, max_degree, cw=0.001):
    # the build's "working" mode (sane degree objective + consistent tanh)
    return FixedKANConfig(
        network_shape=shape,
        max_degree=max_degree,
        complexity_weight=cw,
        degree_objective="penalized_mse",
        consistent_tanh=True,
    )


def test_complex_noisy_piecewise_target():
    # reference fixed_kan_tests.py:24-43: noisy piecewise target
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(-1, 1, 400)).reshape(-1, 1)
    y = np.where(
        x < 0, np.sin(3 * np.pi * x), np.sign(np.sin(3 * np.pi * x))
    ) + 0.05 * rng.normal(size=(400, 1))
    kan = FixedKAN(_working_config([1, 8, 1], max_degree=7))
    kan.optimize(jnp.asarray(x), jnp.asarray(y), solver="anneal", num_reads=128)
    kan.train(
        jnp.asarray(x), jnp.asarray(y), epochs=40, batch_size=64,
        learning_rate=0.01, loss="mse",
    )
    mse = float(jnp.mean((kan(jnp.asarray(x)) - jnp.asarray(y)) ** 2))
    # noise floor 0.0025, zero-predictor 0.77, achieved 0.048: the bar sits
    # 2.5x above achieved so it constrains real quality, not just "did
    # anything run" (the old 0.5 bar passed a 35%-of-variance fit)
    assert mse < 0.12, mse


def test_2d_fractal_function_grid():
    # reference fixed_kan_tests.py:208-291: 2-D function on a 50x50 grid
    n_grid = 30
    g = np.linspace(-1, 1, n_grid)
    X1, X2 = np.meshgrid(g, g)
    x = np.column_stack([X1.ravel(), X2.ravel()])
    y = (np.sin(3 * X1) * np.cos(2 * X2) + 0.5 * X1 * X2).ravel().reshape(-1, 1)

    kan = FixedKAN(_working_config([2, 6, 1], max_degree=5))
    kan.optimize(jnp.asarray(x), jnp.asarray(y), solver="exact")
    base_mse = float(jnp.mean((kan(jnp.asarray(x)) - jnp.asarray(y)) ** 2))
    kan.train(
        jnp.asarray(x), jnp.asarray(y), epochs=50, batch_size=128,
        learning_rate=0.02, loss="mse",
    )
    mse = float(jnp.mean((kan(jnp.asarray(x)) - jnp.asarray(y)) ** 2))
    assert mse <= base_mse
    # zero-predictor MSE for this target is 0.233 -- the bar must sit BELOW
    # it or an all-zeros model passes; achieved is 0.093
    assert mse < 0.15, (base_mse, mse)

    # analysis + visualization on 2-D input exercises the 3-D/contour path
    analysis = kan.analyze_network(jnp.asarray(x))
    fig = kan.visualize_analysis(analysis, x, y)
    assert fig is not None


def test_sin_fit_selects_degree_above_3():
    # reference Tests_TorchDegreeOptimizer.py:64-76: sin fit needs degree > 3
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (300, 1))
    y = np.sin(2.5 * x)
    df = pd.DataFrame(x, columns=["feature_00"])
    opt = DegreeOptimizer(network_shape=[1, 1], max_degree=7)
    opt.fit(df, y, num_reads=128, num_sweeps=300)
    selected = opt.optimal_degrees[0][0]
    assert selected > 3, f"selected degree {selected}"


def test_dtype_parity_f32_vs_f64():
    # the build's analog of the reference's CPU/GPU parity test
    # (Tests_TorchDegreeOptimizer.py:96-114): same degrees + close scores
    # across float32 and float64 evaluation.
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (200, 1))
    y = 0.5 * x**3 - 0.3 * x**2 + 0.1 * x
    df = pd.DataFrame(x, columns=["feature_00"])

    opt64 = DegreeOptimizer(network_shape=[1, 1], max_degree=4)
    s64, _ = opt64.evaluate_degree(df, y)
    opt32 = DegreeOptimizer(network_shape=[1, 1], max_degree=4)
    s32, _ = opt32.evaluate_degree(
        df.astype(np.float32), y.astype(np.float32)
    )
    np.testing.assert_allclose(s32, s64, atol=1e-4)
    assert np.argmin(s32) == np.argmin(s64)


def test_chain_sharded_annealing_on_mesh():
    # SURVEY section 2: num_reads chains sharded across devices
    mesh = make_mesh(8, axis_name="d")
    scores = np.array([0.8, 0.35, 0.3, 0.29])
    model = degree_selection_qubo(scores, num_functions=4, complexity_weight=0.1)
    samples, energies = simulated_annealing_sharded(
        model, mesh, axis_name="d", num_reads=256, num_sweeps=300, seed=0
    )
    assert samples.shape[0] >= 256
    assert energies.shape[0] == samples.shape[0]
    # energies consistent with samples
    np.testing.assert_allclose(energies, model.energy(samples), atol=1e-4)
    # chains on different devices explored different states
    assert len({tuple(s) for s in samples[:64]}) > 1
    # GROUND-TRUTH teeth: the degree QUBO is block-independent, so the
    # global optimum is the blockwise argmin energy -- the sharded chains
    # must actually find it (random initial states do not)
    dp1 = len(scores)
    best = np.zeros(dp1 * 4)
    h = np.asarray(model.h)
    J = np.asarray(model.J)
    for blk in range(4):
        sl = slice(blk * dp1, (blk + 1) * dp1)
        cand_e = []
        for d in range(dp1):
            s = np.zeros_like(best)
            s[blk * dp1 + d] = 1.0
            cand_e.append(h[sl] @ s[sl] + 0.5 * s[sl] @ J[sl, sl] @ s[sl])
        best[blk * dp1 + int(np.argmin(cand_e))] = 1.0
    truth = float(model.energy(best))
    assert float(energies.min()) <= truth + 1e-9, (energies.min(), truth)


def test_visualize_analysis_1d(tmp_path):
    x = jnp.asarray(np.linspace(-1, 1, 100).reshape(-1, 1))
    y = 0.5 * x**2
    kan = FixedKAN(_working_config([1, 3, 1], max_degree=3))
    kan.optimize(x, y, solver="exact")
    analysis = kan.analyze_network(x)
    save = str(tmp_path / "viz.png")
    kan.visualize_analysis(analysis, np.asarray(x), np.asarray(y), save_path=save)
    import pathlib

    assert pathlib.Path(save).exists()


def test_run_records_jsonl(tmp_path):
    from qkan_implementation.utils.run_records import RunRecorder

    rec = RunRecorder(str(tmp_path / "runs.jsonl"))
    rec.record(experiment="e1", mse=np.float64(0.5), arr=np.array([1, 2]))
    rec.record(experiment="e1", mse=0.4)
    entries = rec.read_all()
    assert len(entries) == 2
    assert entries[0]["mse"] == 0.5
    assert entries[0]["arr"] == [1, 2]
    assert "ts" in entries[1]
