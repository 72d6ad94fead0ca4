"""Analysis-layer tests (reference L6 components #18-#20)."""

import json

import numpy as np
import pandas as pd
import jax.numpy as jnp

from qkan_implementation.analysis import (
    SparsityMetrics,
    analyze_models,
    analyze_sample_distribution,
    compare_multiple_samples,
    compute_model_stats,
    compute_sparsity,
    extract_degrees_from_checkpoint,
    print_sparsity_analysis,
)
from qkan_implementation.models import FixedKAN, FixedKANConfig


def test_sparsity_metrics(tmp_path):
    path = str(tmp_path / "sp.parquet")
    n = 300
    rng = np.random.default_rng(0)
    f0 = rng.normal(size=n)
    f0[:50] = np.nan  # a 50-long null cluster at the start
    f1 = rng.normal(size=n)
    f1[rng.uniform(size=n) < 0.1] = np.nan
    pd.DataFrame(
        {
            "date_id": np.repeat(np.arange(10), 30),
            "feature_00": f0,
            "feature_01": f1,
            "other": np.ones(n),
        }
    ).to_parquet(path)

    metrics = compute_sparsity(path, chunk_size=100)
    assert isinstance(metrics, SparsityMetrics)
    expected_overall = (np.isnan(f0).sum() + np.isnan(f1).sum()) / (2 * n)
    np.testing.assert_allclose(metrics.overall_sparsity, expected_overall, atol=1e-12)
    np.testing.assert_allclose(
        metrics.column_sparsity["feature_00"], np.isnan(f0).mean(), atol=1e-12
    )
    # the 50-null head cluster must be detected (chunked into 100-row batches)
    assert any(s == 0 and e >= 50 for s, e in metrics.zero_clusters)
    # per-date rates: date 0 has the 30 leading nulls of f0 plus f1 nulls
    assert "0" in metrics.time_based_sparsity
    print_sparsity_analysis(metrics)  # smoke: must not raise


def test_sample_distribution_analysis():
    rng = np.random.default_rng(1)
    y_full = rng.integers(0, 10, 2000)
    x_full = rng.uniform(0, 1, (2000, 64))
    result = analyze_sample_distribution(
        x_full[:300], y_full[:300], full_labels=y_full, verbose=False
    )
    assert result["class_counts"].sum() == 300
    assert result["max_distribution_diff"] is not None
    assert result["statistics"]["total_samples"] == 300

    multi = compare_multiple_samples(
        x_full, y_full, sample_size=200, num_runs=3, verbose=False
    )
    assert len(multi["sample_results"]) == 3
    assert multi["variations"]["per_class"].shape == (10,)
    assert multi["variations"]["max"] >= multi["variations"]["mean"] >= 0


def test_model_analysis_round_trip(tmp_path):
    x = jnp.asarray(np.linspace(-1, 1, 80).reshape(-1, 1))
    y = 0.5 * x**2 + 0.3 * x + 0.1
    kan = FixedKAN(
        FixedKANConfig(
            network_shape=[1, 3, 1],
            max_degree=3,
            degree_objective="penalized_mse",
            complexity_weight=0.001,
        )
    )
    kan.optimize(x, y, solver="exact")
    model_path = str(tmp_path / "m.npz")
    kan.save_model(model_path)
    results_path = str(tmp_path / "r.json")
    with open(results_path, "w") as f:
        json.dump({"metrics": {"test_accuracy": 0.9}}, f)

    info = extract_degrees_from_checkpoint(model_path)
    assert len(info["layers"]) == 2
    assert info["config"]["max_degree"] == 3

    stats = compute_model_stats(info)
    assert len(stats["layers"]) == 2
    assert sum(stats["degree_histogram"]) == 4  # 3 + 1 neurons
    assert 0.0 <= stats["layers"][0]["coeff_sparsity"] <= 1.0

    all_stats, fig = analyze_models(
        [model_path], [results_path], make_plots=True
    )
    assert all_stats[0]["results"]["metrics"]["test_accuracy"] == 0.9
    assert fig is not None


def test_sparsity_clusters_merge_across_chunk_boundaries(tmp_path):
    """Regression: clusters were computed per chunk, so a null run spanning
    a chunk boundary was split into fragments that each fell under
    cluster_min_len and vanished."""
    import pandas as pd
    from qkan_implementation.analysis.sparsity import compute_sparsity

    n = 60
    col = np.arange(n, dtype=float)
    # one 20-row null run centered on the row-30 chunk boundary
    col[20:40] = np.nan
    df = pd.DataFrame({"feature_00": col})
    path = str(tmp_path / "s.parquet")
    df.to_parquet(path)

    m = compute_sparsity(path, chunk_size=30, cluster_min_len=10)
    assert m.zero_clusters == [(20, 40)], m.zero_clusters
    # whole-file single chunk agrees
    m2 = compute_sparsity(path, chunk_size=1000, cluster_min_len=10)
    assert m2.zero_clusters == [(20, 40)]


def test_plot_sample_distributions_widened_labels():
    """Labels beyond the nominal class range widen
    analyze_sample_distribution's arrays; the bar plot must follow the
    actual array length instead of crashing on a shape mismatch
    (review r3)."""
    from qkan_implementation.analysis.mnist_diagnostics import (
        plot_sample_distributions,
    )

    rng = np.random.default_rng(2)
    y = np.concatenate([rng.integers(0, 10, 290), [11] * 10])
    x = rng.uniform(0, 1, (300, 8))
    res = analyze_sample_distribution(x, y, verbose=False)
    assert len(res["class_percentages"]) == 12  # widened
    fig = plot_sample_distributions([res], num_classes=10)
    assert fig is not None
