"""Data pipeline + experiment harness end-to-end tests.

Mirrors the reference's L5 harness behavior (Testing and Visualization
Framework/): quantile normalization semantics, date-based splits, YAML config
round-trip with 'auto' features, and a full run_experiment on a synthetic
Jane-Street-shaped parquet.
"""

import numpy as np
import pandas as pd
import pytest
import yaml

from qkan_implementation.data import (
    DataPipeline,
    generate_market_parquet,
    load_mnist,
    to_one_hot,
)
from qkan_implementation.experiments import (
    load_config,
    get_default_features,
    run_experiment,
)
from qkan_implementation.experiments.config import DataConfig


def small_config(tmp_path, n_features=4, n_rows=400):
    parquet = generate_market_parquet(
        str(tmp_path / "train.parquet"), n_rows=n_rows, n_features=n_features
    )
    return DataConfig(
        data_path=parquet,
        n_rows=n_rows,
        train_ratio=0.8,
        feature_cols=[f"feature_{i:02d}" for i in range(n_features)],
        target_col="responder_6",
        weight_col="weight",
        date_col="date_id",
    )


def test_normalization_bounds_and_clamping(tmp_path):
    cfg = small_config(tmp_path)
    pipeline = DataPipeline(cfg)
    train_df, train_target, train_w, val_df, val_target, val_w = (
        pipeline.load_and_preprocess_data()
    )
    for df in (train_df, val_df):
        vals = df.to_numpy()
        assert np.all(vals >= -1.0) and np.all(vals <= 1.0)
        # clamping puts mass exactly at the boundaries (5% beyond each quantile)
        assert np.mean(vals == 1.0) > 0.01
        assert np.mean(vals == -1.0) > 0.01
    assert np.all(np.abs(train_target.to_numpy()) <= 1.0)


def test_split_is_date_based(tmp_path):
    cfg = small_config(tmp_path)
    pipeline = DataPipeline(cfg)
    df = pd.read_parquet(cfg.data_path).fillna(3)
    df = df.tail(cfg.n_rows).sort_values(cfg.date_col).reset_index(drop=True)
    norm = pipeline._normalize_features(df)
    train_feats, _, _, val_feats, _, _ = pipeline._train_val_split(norm)
    # dates are disjoint between train and val
    n_train = len(train_feats)
    dates = norm[cfg.date_col].to_numpy()
    assert set(dates[:n_train]).isdisjoint(set(dates[n_train:]))
    assert len(train_feats) + len(val_feats) == cfg.n_rows


def test_constant_feature_fallback(tmp_path):
    # scale falls back to std then 1.0 when q05 == q95 (data_pipeline.py:57)
    path = str(tmp_path / "c.parquet")
    df = pd.DataFrame(
        {
            "date_id": np.arange(50),
            "weight": np.ones(50),
            "feature_00": np.ones(50) * 7.0,
            "responder_6": np.linspace(-1, 1, 50),
        }
    )
    df.to_parquet(path)
    cfg = DataConfig(
        data_path=path,
        n_rows=50,
        train_ratio=0.8,
        feature_cols=["feature_00"],
        target_col="responder_6",
        weight_col="weight",
        date_col="date_id",
    )
    train_df, *_ = DataPipeline(cfg).load_and_preprocess_data()
    vals = train_df.to_numpy()
    assert np.all(np.isfinite(vals))
    # the documented fallback (scale -> std -> 1.0) centers a constant
    # column to EXACTLY zero; finiteness alone passes for any wrong scale
    assert np.all(vals == 0.0), vals[:3]


def test_yaml_config_auto_features(tmp_path):
    cfg_dict = {
        "name": "t",
        "data": {
            "data_path": "x.parquet",
            "n_rows": 10,
            "train_ratio": 0.8,
            "feature_cols": "auto",
            "target_col": "responder_6",
            "weight_col": "weight",
            "date_col": "date_id",
        },
        "models": [
            {"model_type": "qkan", "network_shape": [79, 1], "max_degree": 3}
        ],
        "random_seed": 42,
        "num_trials": 1,
        "save_path": str(tmp_path),
        "log_path": str(tmp_path),
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg_dict))
    config = load_config(str(path))
    assert config.data.feature_cols == get_default_features()
    assert len(config.data.feature_cols) == 79
    assert config.models[0].max_degree == 3


def test_run_experiment_end_to_end(tmp_path):
    n_features = 4
    parquet = generate_market_parquet(
        str(tmp_path / "train.parquet"), n_rows=400, n_features=n_features
    )
    cfg_dict = {
        "name": "mini_experiment",
        "data": {
            "data_path": parquet,
            "n_rows": 400,
            "train_ratio": 0.8,
            "feature_cols": [f"feature_{i:02d}" for i in range(n_features)],
            "target_col": "responder_6",
            "weight_col": "weight",
            "date_col": "date_id",
        },
        "models": [
            {
                "model_type": "qkan",
                "network_shape": [n_features, 1],
                "max_degree": 3,
                "complexity_weight": 0.1,
                "significance_threshold": 0.05,
                "num_reads": 32,
            },
            {
                "model_type": "mlp",
                "network_shape": [n_features, 8, 1],
                "hidden_dims": [8],
                "learning_rate": 0.001,
                "batch_size": 64,
                "n_epochs": 3,
            },
        ],
        "random_seed": 42,
        "num_trials": 2,
        "save_path": str(tmp_path / "results"),
        "log_path": str(tmp_path / "logs"),
    }
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg_dict))

    results = run_experiment(str(cfg_path))
    # 2 models x 2 trials, returned AFTER the loop (reference returned inside)
    assert len(results) == 4
    names = [r.model_name for r in results]
    assert "qkan_trial_0" in names and "mlp_trial_1" in names
    for r in results:
        assert np.isfinite(r.MSE_Score)
        assert r.train_time > 0

    out = tmp_path / "results"
    assert (out / "metrics_comparison.png").exists()
    assert (out / "training_time_comparison.png").exists()
    assert (out / "degree_distribution.png").exists()
    assert (out / "results_summary.csv").exists()
    summary = pd.read_csv(out / "results_summary.csv")
    assert set(["model", "mse", "r2", "train_time"]).issubset(summary.columns)
    assert (tmp_path / "logs" / "mini_experiment.log").exists()


def test_mnist_fallback_loader(tmp_path):
    # empty data root FORCES the sklearn-digits fallback; without pinning
    # the source, a machine with real MNIST files would silently test the
    # idx loader instead and the 64-dim digits contract would go untested
    x, y, meta = load_mnist(root=str(tmp_path), train=True)
    xt, yt, _ = load_mnist(root=str(tmp_path), train=False)
    assert meta["source"] == "digits", meta
    assert meta["image_dim"] == 64
    assert x.ndim == 2 and x.shape[1] == meta["image_dim"]
    assert x.min() >= 0.0 and x.max() <= 1.0
    assert set(np.unique(y)).issubset(set(range(10)))
    assert len(x) > len(xt)
    one_hot = to_one_hot(y[:5], 10)
    assert one_hot.shape == (5, 10)
    np.testing.assert_array_equal(one_hot.sum(axis=1), np.ones(5))


def test_run_experiment_fixed_kan_model(tmp_path):
    n_features = 4
    parquet = generate_market_parquet(
        str(tmp_path / "train.parquet"), n_rows=400, n_features=n_features
    )
    cfg_dict = {
        "name": "fixed_kan_experiment",
        "data": {
            "data_path": parquet,
            "n_rows": 400,
            "train_ratio": 0.8,
            "feature_cols": [f"feature_{i:02d}" for i in range(n_features)],
            "target_col": "responder_6",
            "weight_col": "weight",
            "date_col": "date_id",
        },
        "models": [
            {
                "model_type": "fixed_kan",
                "network_shape": [n_features, 4, 1],
                "max_degree": 3,
                "complexity_weight": 0.001,
                "num_reads": 32,
                "n_epochs": 5,
                "batch_size": 64,
                "learning_rate": 0.01,
            }
        ],
        "random_seed": 1,
        "num_trials": 1,
        "save_path": str(tmp_path / "results"),
        "log_path": str(tmp_path / "logs"),
    }
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg_dict))
    results = run_experiment(str(cfg_path))
    assert len(results) == 1
    r = results[0]
    assert r.model_name == "fixed_kan_trial_0"
    assert np.isfinite(r.MSE_Score)
    assert len(r.model_params["degrees"]) == 2  # two layers


def test_run_experiment_with_degree_cv(tmp_path):
    # the CV-fold degree-scoring config option: scores come from
    # evaluate_degree_cv over time folds instead of in-sample
    import yaml

    from qkan_implementation.data.pipeline import generate_market_parquet
    from qkan_implementation.experiments.main import run_experiment

    parquet = generate_market_parquet(
        tmp_path / "data.parquet", n_rows=1200, n_features=6, seed=0
    )
    cfg = {
        "name": "cv_test",
        "data": {
            "data_path": str(parquet),
            "n_rows": 1200,
            "train_ratio": 0.7,
            "feature_cols": [f"feature_{i:02d}" for i in range(6)],
            "target_col": "responder_6",
            "weight_col": "weight",
            "date_col": "date_id",
        },
        "models": [
            {
                "model_type": "qkan",
                "network_shape": [6, 1],
                "max_degree": 3,
                "complexity_weight": 0.0,
                "num_reads": 16,
                "degree_cv": {"n_splits": 3, "strategy": "expanding"},
            }
        ],
        "num_trials": 1,
        "random_seed": 1,
        "save_path": str(tmp_path / "out"),
        "log_path": str(tmp_path / "out" / "log.txt"),
    }
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    # spy: the CV scoring path must actually run (count/finiteness hold
    # with CV silently disabled, e.g. a dropped or renamed degree_cv key)
    from qkan_implementation.optim.degree_optimizer import DegreeOptimizer

    calls = {}
    orig_cv = DegreeOptimizer.evaluate_degree_cv

    def spy(self, *a, **k):
        calls["n_splits"] = k.get("n_splits")
        return orig_cv(self, *a, **k)

    DegreeOptimizer.evaluate_degree_cv = spy
    try:
        results = run_experiment(str(cfg_path))
    finally:
        DegreeOptimizer.evaluate_degree_cv = orig_cv
    assert calls.get("n_splits") == 3, "degree_cv path did not run"
    assert len(results) == 1
    assert np.isfinite(results[0].MSE_Score)


def test_metrics_integer_targets_and_small_scale():
    """Regression trio for utils.metrics: integer targets must score (not
    crash on jnp.finfo of an int dtype); tiny-magnitude targets must not be
    zeroed by an absolute-eps degeneracy guard; all-zero weights return the
    same guarded 0.0 across mse and both R^2 flavors."""
    from qkan_implementation.utils.metrics import (
        mse,
        r2_score,
        weighted_competition_r2,
    )

    assert r2_score([1, 2, 3], [1, 2, 3]) == 1.0
    assert weighted_competition_r2([1, 2, 3], [1, 2, 3]) == 1.0

    y = np.array([1e-4, 1.5e-4, 0.7e-4])
    pred = y.copy()
    assert r2_score(y, pred) == 1.0  # absolute-eps guard would return 0.0

    z = np.zeros(3)
    assert mse(y, pred, weights=z) == 0.0
    assert r2_score(y, pred, weights=z) == 0.0
    assert weighted_competition_r2(y, pred, weights=z) == 0.0


def test_pairwise_exchange_validates_inputs():
    from qkan_implementation.parallel.collectives import pairwise_exchange

    with pytest.raises(ValueError, match="power-of-two"):
        pairwise_exchange(np.zeros(4), "d", 1, 6)
    with pytest.raises(ValueError, match="out of range"):
        pairwise_exchange(np.zeros(4), "d", 3, 8)


def test_generate_market_parquet_top_profile(tmp_path):
    """'top' profile: high-signal curated regime (r5).  Structural
    contracts -- schema parity with the other profiles, per-profile
    signal_frac defaulting, bounded-term construction, and the feature
    guard."""
    import pandas as pd

    from qkan_implementation.data.pipeline import generate_market_parquet

    p = generate_market_parquet(
        tmp_path / "top.parquet", n_rows=4000, n_features=8, n_dates=40,
        seed=3, profile="top",
    )
    df = pd.read_parquet(p)
    assert {"date_id", "weight", "responder_6"} <= set(df.columns)
    assert df.shape == (4000, 3 + 8)
    assert (df["weight"] > 0).all()
    # ~2% nulls per feature column (the fillna path exercise)
    null_frac = df[[c for c in df.columns if c.startswith("feature")]].isna().mean().mean()
    assert 0.005 < null_frac < 0.05
    # target is signal+noise mixed at unit-ish scale
    assert 0.5 < df["responder_6"].std() < 2.0

    # signal_frac=None resolves per profile: 'top' (0.5) must carry much
    # more recoverable signal than 'hard' (0.1) on identical seeds --
    # check via correlation of the target with its strongest raw feature
    p_hard = generate_market_parquet(
        tmp_path / "hard.parquet", n_rows=4000, n_features=8, n_dates=40,
        seed=3, profile="hard",
    )
    dh = pd.read_parquet(p_hard)
    def best_abs_corr(d):
        feats = d[[c for c in d.columns if c.startswith("feature")]].fillna(0)
        return max(abs(feats[c].corr(d["responder_6"])) for c in feats)
    assert best_abs_corr(df) > best_abs_corr(dh)

    with pytest.raises(ValueError, match="n_features >= 6"):
        generate_market_parquet(
            tmp_path / "bad.parquet", n_rows=100, n_features=4,
            profile="top",
        )
    with pytest.raises(ValueError, match="unknown profile"):
        generate_market_parquet(
            tmp_path / "bad2.parquet", n_rows=100, profile="tail"
        )
