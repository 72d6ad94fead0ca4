"""DegreeOptimizer tests.

Mirrors the reference suites: polynomial-degree recovery with MSE < 0.1 and
monotone scores (Tests_TorchDegreeOptimizer.py:35-76), weighted-vs-unweighted
divergence (:78-94), fold construction (BaseOptimizer.py:38-99), and
save/load with query validation (DegreeOptimizer.py:314-386).
"""

import numpy as np
import pandas as pd
import pytest

from qkan_implementation.optim import BaseOptimizer, DegreeOptimizer


def poly_frame(n=200, degree=3, seed=0, n_features=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, n_features))
    coeffs = [0.0, 0.5, -0.3, 0.8, 0.2][: degree + 1]
    y = sum(c * x[:, 0] ** d for d, c in enumerate(coeffs))
    df = pd.DataFrame(
        x, columns=[f"feature_{i:02d}" for i in range(n_features)]
    )
    return df, y.reshape(-1, 1)


@pytest.mark.parametrize("true_degree", [2, 3, 4])
def test_polynomial_fit_quality(true_degree):
    df, y = poly_frame(degree=true_degree)
    opt = DegreeOptimizer(network_shape=[1, 1], max_degree=5)
    scores, comp_r2 = opt.evaluate_degree(df, y)
    # scores monotonically non-increasing with cumulative degree
    assert all(
        scores[d + 1] <= scores[d] + 1e-9 for d in range(len(scores) - 1)
    )
    # by the true degree, fit is essentially exact
    assert scores[true_degree] < 1e-10
    assert scores[-1] < 0.1  # the reference bar


def test_is_degree_definitive():
    opt = DegreeOptimizer(network_shape=[1, 1], max_degree=3)
    definitive, best = opt.is_degree_definitive(np.array([0.9, 0.5, 1e-8, 1e-8]))
    assert best == 2 or best == 3
    assert not definitive  # degrees 2 and 3 are indistinguishable
    definitive, best = opt.is_degree_definitive(np.array([0.9, 0.5, 0.01, 0.3]))
    assert definitive and best == 2


def test_fit_predict_shapes_and_quality():
    # N=2 features -> K=1 output; degree-2 target on feature 0
    rng = np.random.default_rng(1)
    n = 300
    x = rng.uniform(-1, 1, (n, 2))
    y = (2 * x[:, 0] ** 2 - 1).reshape(-1, 1)  # T_2 of feature 0
    df = pd.DataFrame(x, columns=["feature_00", "feature_01"])
    opt = DegreeOptimizer(network_shape=[2, 1], max_degree=3)
    opt.fit(df, y, num_reads=64, num_sweeps=200)
    assert opt.optimal_degrees is not None
    assert len(opt.optimal_degrees) == 1 and len(opt.optimal_degrees[0]) == 2
    preds = opt.predict(df)
    assert preds.shape == (n, 1)
    assert np.all(np.isfinite(preds))


def test_weighted_changes_scores():
    # weighted-vs-unweighted evaluation must differ
    # (Tests_TorchDegreeOptimizer.py:78-94)
    df, y = poly_frame(degree=3, n=150)
    rng = np.random.default_rng(2)
    w = rng.uniform(0.1, 2.0, len(y))
    # IDENTICAL noisy target for both calls: with fresh noise per call the
    # scores would differ even if the weights argument were ignored
    yn = y + 0.1 * rng.normal(size=y.shape)
    opt = DegreeOptimizer(network_shape=[1, 1], max_degree=3)
    s_unweighted, _ = opt.evaluate_degree(df, yn)
    opt2 = DegreeOptimizer(network_shape=[1, 1], max_degree=3)
    s_weighted, _ = opt2.evaluate_degree(df, yn, weights=w)
    assert not np.allclose(s_unweighted, s_weighted)


def test_transform_caching():
    df, y = poly_frame()
    opt = DegreeOptimizer(network_shape=[1, 1], max_degree=3)
    opt.evaluate_degree(df, y)
    assert len(opt.transform_cache) == 1
    opt.evaluate_degree(df, y)  # second call hits both caches
    assert len(opt.transform_cache) == 1
    assert len(opt.degree_scores) == 1


def test_expanding_window_folds():
    dates = np.repeat(np.arange(10), 5)  # 10 unique dates x 5 rows
    df = pd.DataFrame({"date_id": dates})
    opt = DegreeOptimizer(network_shape=[1, 1], max_degree=2)
    folds = opt._get_expanding_window_folds(df, n_splits=2, initial_ratio=0.6)
    assert len(folds) == 2
    train0, val0 = folds[0]
    # initial train = 6 dates, val = 2 dates
    assert train0.sum() == 30 and val0.sum() == 10
    train1, val1 = folds[1]
    assert train1.sum() == 40 and val1.sum() == 10
    # expanding: train grows, no overlap between train and its val
    assert not np.any(train0 & val0)


def test_time_based_folds():
    dates = np.repeat(np.arange(12), 2)
    opt = DegreeOptimizer(network_shape=[1, 1], max_degree=2)
    folds = opt._get_time_based_folds(dates, n_splits=3)
    assert len(folds) == 3
    for train, val in folds:
        assert not np.any(train & val)
        # time ordering: all val dates after all train dates
        assert dates[train].max() < dates[val].min()


def test_save_load_state_with_query_validation(tmp_path):
    df, y = poly_frame(degree=2)
    opt = DegreeOptimizer(network_shape=[1, 1], max_degree=3)
    opt.fit(df, y, num_reads=32, num_sweeps=100)
    preds = opt.predict(df)

    qp = {"n_rows": 10, "columns": ["feature_00"], "sort_by": "date_id"}
    path = str(tmp_path / "state.npy")
    opt.save_state(path, query_params=qp)

    # matching query: caches retained
    opt2 = DegreeOptimizer(network_shape=[1, 1], max_degree=3)
    opt2.load_state(path, current_query_params=qp)
    np.testing.assert_allclose(opt2.predict(df), preds, atol=1e-12)
    assert opt2.degree_scores  # cache reused

    # mismatched query: caches cleared but weights restored
    opt3 = DegreeOptimizer(network_shape=[1, 1], max_degree=3)
    opt3.load_state(
        path, current_query_params={**qp, "n_rows": 999}
    )
    assert opt3.degree_scores == {}
    np.testing.assert_allclose(opt3.predict(df), preds, atol=1e-12)


def test_predict_before_fit_raises():
    opt = DegreeOptimizer(network_shape=[1, 1], max_degree=2)
    with pytest.raises(RuntimeError):
        opt.predict(np.zeros((3, 1)))


def test_optimize_network_multi_layer():
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-1, 1, (100, 2))
    y0 = rng.normal(size=(100, 1))
    x1 = rng.uniform(-1, 1, (100, 3))
    y1 = rng.normal(size=(100, 1))
    training_data = {
        "layer_0_input": pd.DataFrame(
            x0, columns=["feature_00", "feature_01"]
        ),
        "layer_0_output": y0,
        "layer_1_input": pd.DataFrame(
            x1, columns=["feature_00", "feature_01", "feature_02"]
        ),
        "layer_1_output": y1,
    }
    opt = DegreeOptimizer(network_shape=[2, 3, 1], max_degree=2)
    degrees = opt.optimize_network(training_data, num_reads=32)
    assert len(degrees) == 2
    assert len(degrees[0]) == 3 and len(degrees[0][0]) == 2
    assert len(degrees[1]) == 1 and len(degrees[1][0]) == 3


def test_analyze_and_visualize_network(tmp_path):
    # reference TorchDegreeOptimizer.analyze_network/visualize_analysis
    # (:330-428): neuron contributions, combined fit, activation plot
    df, y = poly_frame(degree=3, n=200)
    opt = DegreeOptimizer(network_shape=[1, 2], max_degree=4)
    opt.fit(df, y, num_reads=64, num_sweeps=200)
    analysis = opt.analyze_network(df, y)
    assert analysis["neuron_contributions"].shape == (2, 200)
    assert len(analysis["neuron_degrees"]) == 2
    np.testing.assert_allclose(
        analysis["combined_fit"],
        analysis["neuron_contributions"].sum(axis=0),
        atol=1e-10,
    )
    save = str(tmp_path / "analysis.png")
    fig = opt.visualize_analysis(analysis, df, y, save_path=save)
    assert fig is not None
    import pathlib
    assert pathlib.Path(save).exists()


def test_evaluate_degree_cv():
    # CV-fold degree scoring: out-of-sample scores should still identify
    # the true polynomial degree, and overfit degrees should stop improving.
    rng = np.random.default_rng(5)
    n = 600
    dates = np.repeat(np.arange(30), 20)
    x = rng.uniform(-1, 1, (n, 1))
    y = (0.8 * x[:, 0] ** 3 - 0.2 * x[:, 0] + 0.05 * rng.normal(size=n)).reshape(-1, 1)
    df = pd.DataFrame(x, columns=["feature_00"])
    opt = DegreeOptimizer(network_shape=[1, 1], max_degree=6)
    scores, comp_r2 = opt.evaluate_degree_cv(
        df, y, timestamps=dates, n_splits=3, strategy="expanding"
    )
    assert scores.shape == (7,)
    # degree 3 captures the target: large drop by d=3, flat after
    assert scores[3] < 0.5 * scores[1]
    assert abs(scores[6] - scores[3]) < 0.05
    # time-based strategy also works
    s2, _ = opt.evaluate_degree_cv(
        df, y, timestamps=dates, n_splits=3, strategy="time"
    )
    assert s2.shape == (7,)
    with pytest.raises(ValueError):
        opt.evaluate_degree_cv(df, y, timestamps=dates, strategy="nope")


class TestFullNetworkFit:
    """fit(full_network=True) exceeds the reference's layer-0 ceiling
    (DegreeOptimizer.py:42-76 optimizes layer 0 only; :256-275's
    optimize_network is never wired into fit/predict)."""

    def _data(self):
        rng = np.random.default_rng(21)
        x = rng.uniform(-1, 1, (400, 4))
        y = 0.6 * x[:, 0] ** 2 - 0.4 * x[:, 1] + 0.2 * x[:, 2] * 0 + 0.1
        return x, y

    def test_stack_shapes_and_predict(self):
        x, y = self._data()
        opt = DegreeOptimizer(
            network_shape=[4, 4, 1], max_degree=3, complexity_weight=0.0
        )
        opt.fit(x, y, full_network=True, num_reads=64, num_sweeps=64)
        assert opt.qkan_weights_stack is not None
        assert len(opt.qkan_weights_stack) == 2
        assert opt.qkan_weights_stack[0].shape == (4, 16)
        assert opt.qkan_weights_stack[1].shape == (4, 4)
        pred = opt.predict(x)
        assert pred.shape == (400, 1)
        assert np.all(np.isfinite(pred))

    def test_layer0_only_default_unchanged(self):
        x, y = self._data()
        opt = DegreeOptimizer(
            network_shape=[4, 4, 1], max_degree=3, complexity_weight=0.0
        )
        opt.fit(x, y, num_reads=64, num_sweeps=64)
        assert opt.qkan_weights_stack is None
        pred = opt.predict(x)
        assert pred.shape == (400, 4)  # reference ceiling: first layer only

    def test_save_load_round_trip_stack(self, tmp_path):
        x, y = self._data()
        opt = DegreeOptimizer(
            network_shape=[4, 2, 1], max_degree=2, complexity_weight=0.0
        )
        opt.fit(x, y, full_network=True, num_reads=32, num_sweeps=32)
        want = opt.predict(x)
        qp = {"n_rows": 1, "columns": ["a"], "sort_by": "a"}
        path = str(tmp_path / "state.npy")
        opt.save_state(path, query_params=qp)
        opt2 = DegreeOptimizer(network_shape=[4, 2, 1], max_degree=2)
        opt2.load_state(path, current_query_params=qp)
        got = opt2.predict(x)
        np.testing.assert_allclose(got, want, atol=1e-12)


class TestMultiTarget:
    """Multi-target degree scoring: y may be [n, T]; residuals pool across
    targets identically in both scoring methods (beyond the reference,
    whose evaluate_degree flattens y to a scalar column)."""

    def _data(self, n=300, seed=5):
        rng = np.random.default_rng(seed)
        x = rng.uniform(-1, 1, (n, 2))
        y = np.stack(
            [
                0.7 * x[:, 0] ** 3 - 0.2 * x[:, 1],
                0.5 * x[:, 1] ** 2 + 0.1 * x[:, 0],
            ],
            axis=1,
        )
        return x, y

    def test_gram_matches_svd(self):
        x, y = self._data()
        a = DegreeOptimizer(network_shape=[2, 2], max_degree=4)
        s_svd, r_svd = a.evaluate_degree(x, y, method="svd")
        b = DegreeOptimizer(network_shape=[2, 2], max_degree=4)
        s_gram, r_gram = b.evaluate_degree(x, y, method="gram")
        np.testing.assert_allclose(s_gram, s_svd, rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(r_gram, r_svd, rtol=1e-6, atol=1e-10)

    def test_weighted_gram_matches_svd(self):
        x, y = self._data()
        rng = np.random.default_rng(1)
        w = rng.uniform(0.2, 2.0, x.shape[0])
        a = DegreeOptimizer(network_shape=[2, 2], max_degree=3)
        s_svd, _ = a.evaluate_degree(x, y, weights=w, method="svd")
        b = DegreeOptimizer(network_shape=[2, 2], max_degree=3)
        s_gram, _ = b.evaluate_degree(x, y, weights=w, method="gram")
        np.testing.assert_allclose(s_gram, s_svd, rtol=1e-6, atol=1e-10)

    def test_scalar_column_matches_flat(self):
        # [n] and [n, 1] must score identically (reference semantics kept)
        x, y = self._data()
        a = DegreeOptimizer(network_shape=[2, 2], max_degree=3)
        s1, _ = a.evaluate_degree(x, y[:, 0], method="svd")
        b = DegreeOptimizer(network_shape=[2, 2], max_degree=3)
        s2, _ = b.evaluate_degree(x, y[:, 0:1], method="svd")
        np.testing.assert_allclose(s1, s2, atol=1e-12)

    def test_full_network_multi_output_fit(self):
        x, y = self._data(n=400)
        opt = DegreeOptimizer(
            network_shape=[2, 4, 2], max_degree=3, complexity_weight=0.0
        )
        opt.fit(x, y, full_network=True, num_reads=64, num_sweeps=64)
        pred = opt.predict(x)
        assert pred.shape == (400, 2)
        assert np.all(np.isfinite(pred))


def test_target_projection_sharpens_multi_target_scores():
    """DegreeOptimizer(target_projection=P): pooled multi-target scoring is
    rotation-invariant, so many pure-noise target columns add a constant
    residual floor to every degree -- the argmin survives but the relative
    improvements collapse below the definitive-degree threshold.  The
    top-P PCA projection (optim.degree_optimizer._project_targets) keeps
    the dominant structure direction and restores definitiveness."""
    rng = np.random.default_rng(41)
    n = 512
    x = rng.uniform(-1, 1, (n, 1))
    signal = 3.0 * np.cos(3.0 * np.arccos(np.clip(x[:, 0], -1, 1)))  # T_3
    noise = rng.normal(size=(n, 31))  # unit-variance distractor targets
    y = np.concatenate([signal[:, None], noise], axis=1)

    pooled = DegreeOptimizer(
        [1, 1], max_degree=3, significance_threshold=0.2
    )
    projected = DegreeOptimizer(
        [1, 1], max_degree=3, significance_threshold=0.2,
        target_projection=1,
    )
    s_pool, _ = pooled.evaluate_degree(x, y, method="svd")
    s_proj, _ = projected.evaluate_degree(x, y, method="svd")

    # both find the right degree...
    assert int(np.argmin(s_pool)) == 3
    assert int(np.argmin(s_proj)) == 3
    # ...but only the projected scores are definitive at this threshold
    ok_pool, _ = pooled.is_degree_definitive(s_pool)
    ok_proj, d_proj = projected.is_degree_definitive(s_proj)
    assert not ok_pool
    assert ok_proj and d_proj == 3
    # gram and svd agree under projection too
    s_gram, _ = DegreeOptimizer(
        [1, 1], max_degree=3, significance_threshold=0.2,
        target_projection=1,
    ).evaluate_degree(x, y, method="gram")
    np.testing.assert_allclose(s_gram, s_proj, rtol=1e-6, atol=1e-10)


def test_weighted_rescore_not_served_from_unweighted_cache():
    """Regression: degree_scores was keyed on (x, y) only, so a weighted
    evaluate_degree on the same data returned the cached UNWEIGHTED scores
    (degree selection from the wrong landscape).  Weights and the resolved
    method are now part of the key."""
    rng = np.random.default_rng(7)
    n = 200
    x = rng.uniform(-1, 1, (n, 2))
    y = x[:, 0] ** 2 + 0.1 * rng.normal(size=n)
    w = (rng.uniform(size=n) < 0.2) * 10.0 + 0.1  # spiky weights

    opt = DegreeOptimizer([2, 1], max_degree=3)
    s_unw, _ = opt.evaluate_degree(x, y, method="svd")
    s_w_cached_path, _ = opt.evaluate_degree(x, y, weights=w, method="svd")
    fresh = DegreeOptimizer([2, 1], max_degree=3)
    s_w_fresh, _ = fresh.evaluate_degree(x, y, weights=w, method="svd")

    np.testing.assert_allclose(s_w_cached_path, s_w_fresh, rtol=1e-12)
    assert not np.allclose(s_w_fresh, s_unw), (
        "weighted scores should differ from unweighted on spiky weights"
    )
