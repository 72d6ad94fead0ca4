"""MNIST/digits classification pipeline + degree-viz tests
(reference components #22, #24)."""

import json
from pathlib import Path

import numpy as np
import pytest

from qkan_implementation.experiments.degree_viz import (
    TEST_FUNCTIONS,
    plot_degree_optimization,
    run_interactive_test,
)
from qkan_implementation.experiments.mnist import (
    run_mnist_experiment,
    run_mnist_n_times,
)


def test_mnist_experiment_end_to_end(tmp_path):
    results = run_mnist_experiment(
        network_shape=[64, 8, 10],
        max_degree=3,
        train_size=600,
        solver="exact",
        degree_objective="penalized_mse",
        complexity_weight=0.001,
        consistent_tanh=True,
        save_dir=str(tmp_path),
        verbose=False,
    )
    m = results["metrics"]
    assert 0.0 <= m["test_accuracy"] <= 1.0
    # with real degree search on digits, the model must beat chance by a lot
    assert m["test_accuracy"] > 0.5, m
    assert m["structure_time_seconds"] > 0

    # artifacts: accuracy-stamped JSON + model (reference naming style)
    files = list(Path(tmp_path).iterdir())
    assert any("mnist_kan_results_acc_" in f.name for f in files)
    assert any(f.suffix == ".npz" for f in files)
    with open(results["results_file"]) as f:
        saved = json.load(f)
    assert saved["metrics"]["test_accuracy"] == m["test_accuracy"]

    # saved model round-trips and reproduces accuracy
    from qkan_implementation.models import FixedKAN
    from qkan_implementation.data.mnist import load_mnist

    loaded = FixedKAN.load_model(results["model_file"])
    x_test, y_test, _ = load_mnist(train=False)
    pred = np.asarray(loaded(x_test)).argmax(axis=1)
    np.testing.assert_allclose(
        float((pred == y_test).mean()), m["test_accuracy"], atol=1e-12
    )


def test_mnist_n_times_statistics():
    stats = run_mnist_n_times(
        n=2,
        network_shape=[64, 4, 10],
        max_degree=2,
        train_size=300,
        solver="exact",
        degree_objective="penalized_mse",
        complexity_weight=0.001,
        consistent_tanh=True,
    )
    assert len(stats["runs"]) == 2
    assert len(stats["distributions"]) == 2
    # pin the aggregates to the per-run values (min<=mean<=max is a
    # tautology that holds for statistics over ANY list)
    accs = [r["metrics"]["test_accuracy"] for r in stats["runs"]]
    np.testing.assert_allclose(stats["test_accuracy_mean"], np.mean(accs))
    np.testing.assert_allclose(stats["test_accuracy_min"], np.min(accs))
    np.testing.assert_allclose(stats["test_accuracy_max"], np.max(accs))
    assert all(a > 0.0 for a in accs), accs


@pytest.mark.parametrize("fn", ["polynomial", "runge"])
def test_interactive_degree_viz(fn, tmp_path):
    save = str(tmp_path / f"{fn}.png")
    optimizer, fig = run_interactive_test(
        function_name=fn, n_points=120, max_degree=5, save_path=save
    )
    assert Path(save).exists()
    assert optimizer.optimal_degrees is not None
    # three-panel variant also renders
    x = np.linspace(-1, 1, 120).reshape(-1, 1)
    y = TEST_FUNCTIONS[fn](x)
    fig2 = plot_degree_optimization(optimizer, x, y)
    assert fig2 is not None


def test_unknown_function_raises():
    with pytest.raises(ValueError):
        run_interactive_test(function_name="nope")


def test_mnist_n_times_ensemble():
    """ensemble=True evaluates the seed-varied members as one soft-voting
    ensemble on the shared fixed test split; the row should be at least
    competitive with the weakest member (soft voting can only be dragged
    below the min by systematic disagreement, not by seed noise)."""
    stats = run_mnist_n_times(
        n=2,
        ensemble=True,
        network_shape=[64, 4, 10],
        max_degree=2,
        train_size=300,
        weight_epochs=2,
        solver="exact",
        degree_objective="penalized_mse",
        complexity_weight=0.001,
        consistent_tanh=True,
    )
    acc = stats["ensemble_test_accuracy"]
    assert 0.0 < acc <= 1.0
    # members trained on 300 samples score well above chance; the
    # ensemble must not collapse relative to them
    assert acc >= stats["test_accuracy_min"] - 0.05, stats
    # no ensemble key unless asked
    base = run_mnist_n_times(
        n=1,
        network_shape=[64, 4, 10],
        max_degree=2,
        train_size=200,
        solver="exact",
        degree_objective="penalized_mse",
        complexity_weight=0.001,
        consistent_tanh=True,
    )
    assert "ensemble_test_accuracy" not in base


def _write_idx(path, arr):
    """Minimal IDX writer (the format torchvision's raw MNIST ships in):
    >HBB header (zero, dtype code 0x08 = uint8, ndim) + big-endian dims +
    raw bytes."""
    import struct

    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def test_load_mnist_idx_branch(tmp_path):
    """The raw-idx resolver (mnist.py:_read_idx/_find) must parse real
    idx files — plain AND gzipped — before any fallback fires (VERDICT
    r3 weak #5: these branches never ran in the suite)."""
    import gzip

    from qkan_implementation.data.mnist import load_mnist

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (4, 28, 28)).astype(np.uint8)
    labels = np.array([3, 1, 4, 1], dtype=np.uint8)
    _write_idx(tmp_path / "train-images-idx3-ubyte", imgs)
    _write_idx(tmp_path / "train-labels-idx1-ubyte", labels)
    x, y, meta = load_mnist(root=str(tmp_path), train=True)
    assert meta["source"] == "mnist-idx"
    assert x.shape == (4, 784) and x.dtype == np.float64
    np.testing.assert_allclose(x, imgs.reshape(4, 784) / 255.0)
    np.testing.assert_array_equal(y, labels.astype(np.int64))

    # gzipped test split resolves through the same finder
    timgs = rng.integers(0, 256, (2, 28, 28)).astype(np.uint8)
    tlabels = np.array([7, 2], dtype=np.uint8)
    import io
    import struct

    for name, arr in (
        ("t10k-images-idx3-ubyte.gz", timgs),
        ("t10k-labels-idx1-ubyte.gz", tlabels),
    ):
        buf = io.BytesIO()
        buf.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        buf.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        buf.write(arr.tobytes())
        with gzip.open(tmp_path / name, "wb") as f:
            f.write(buf.getvalue())
    xt, yt, meta_t = load_mnist(root=str(tmp_path), train=False)
    assert meta_t["source"] == "mnist-idx"
    np.testing.assert_allclose(xt, timgs.reshape(2, 784) / 255.0)
    np.testing.assert_array_equal(yt, tlabels.astype(np.int64))


def test_load_mnist_npz_branch(tmp_path):
    """Keras-style mnist.npz resolves when no idx files exist."""
    from qkan_implementation.data.mnist import load_mnist

    rng = np.random.default_rng(1)
    xtr = rng.integers(0, 256, (5, 28, 28)).astype(np.uint8)
    ytr = np.array([0, 9, 2, 5, 5], dtype=np.uint8)
    np.savez(
        tmp_path / "mnist.npz",
        x_train=xtr,
        y_train=ytr,
        x_test=xtr[:2],
        y_test=ytr[:2],
    )
    x, y, meta = load_mnist(root=str(tmp_path), train=True)
    assert meta["source"] == "mnist-npz"
    np.testing.assert_allclose(x, xtr.reshape(5, 784) / 255.0)
    np.testing.assert_array_equal(y, ytr.astype(np.int64))
    xt, _, _ = load_mnist(root=str(tmp_path), train=False)
    assert xt.shape == (2, 784)


def test_bilinear_upsample_exact_cases():
    """_bilinear_upsample is align-corners bilinear: constant images stay
    constant, and a linear ramp upsamples to the exact linear ramp."""
    from qkan_implementation.data.mnist import _bilinear_upsample

    const = np.full((1, 8, 8), 0.625)
    np.testing.assert_allclose(_bilinear_upsample(const, 28), 0.625)
    ramp = np.tile(np.linspace(0.0, 1.0, 8), (8, 1))[None]
    up = _bilinear_upsample(ramp, 15)
    np.testing.assert_allclose(up[0, 0], np.linspace(0.0, 1.0, 15), atol=1e-12)


def test_improved_degree_viz_multi_feature():
    """plot_degree_optimization_improved must render for MULTI-feature
    fits (review r3: it passed the full [N, F] matrix to scatter/plot,
    crashing exactly the case its docstring claimed to handle; panels
    plot against feature 0 like the sibling function)."""
    from qkan_implementation.experiments.degree_viz import (
        plot_degree_optimization_improved,
    )
    from qkan_implementation.optim.degree_optimizer import (
        DegreeOptimizer,
    )

    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (120, 2))
    y = (0.4 * x[:, :1] ** 2 + 0.2 * x[:, 1:]).astype(float)
    opt = DegreeOptimizer(network_shape=[2, 1], max_degree=4)
    opt.fit(x, y)
    fig = plot_degree_optimization_improved(opt, x, y)
    assert fig is not None
