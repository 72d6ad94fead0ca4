"""MLP baseline trainer tests (reference train_utils.py:10-133 behavior)."""

import numpy as np
import jax.numpy as jnp

from qkan_implementation.models import MLPConfig, mlp_apply, mlp_predict, train_mlp
from qkan_implementation.models.mlp import init_mlp


def make_data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 4))
    y = 0.5 * x[:, 0] - 0.2 * x[:, 1] ** 2 + 0.1 * x[:, 2] * x[:, 3]
    w = rng.uniform(0.5, 1.5, n)
    return x, y, w


def test_forward_shapes_and_batchnorm_modes():
    config = MLPConfig(input_dim=4, hidden_dims=[8, 8])
    params, state = init_mlp(config, seed=0)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(32, 4)))
    out_train, new_state = mlp_apply(params, state, x, train=True)
    assert out_train.shape == (32, 1)
    # running stats moved toward batch stats
    assert not np.allclose(np.asarray(new_state["mean"]), 0.0)
    out_eval, same_state = mlp_apply(params, state, x, train=False)
    assert same_state is state
    assert out_eval.shape == (32, 1)
    # negative control for the batchnorm MODES: with warmed running stats
    # (!= batch stats), eval-mode output must differ from train-mode, and
    # eval mode must be deterministic (pure function of running stats)
    out_eval2, _ = mlp_apply(params, new_state, x, train=False)
    assert not np.allclose(np.asarray(out_eval2), np.asarray(out_train)) or (
        # freshly-initialized stats can coincide; warmed stats cannot
        False
    )
    out_eval3, _ = mlp_apply(params, new_state, x, train=False)
    np.testing.assert_array_equal(
        np.asarray(out_eval2), np.asarray(out_eval3)
    )


def test_training_reduces_validation_mse():
    x, y, w = make_data(512)
    xv, yv, wv = make_data(128, seed=1)
    config = MLPConfig(
        input_dim=4, hidden_dims=[16, 16], learning_rate=1e-2, batch_size=64,
        n_epochs=30,
    )
    scores, compr2, model = train_mlp(
        config, x, y, weights=w, x_val=xv, y_val=yv, w_val=wv, seed=0
    )
    assert len(scores) == len(compr2)
    assert scores[-1] < scores[0]
    # best-state restore: final model at least as good as the best epoch
    pred = mlp_predict(model, xv)
    final_mse = float(np.mean((np.asarray(pred).ravel() - yv) ** 2))
    np.testing.assert_allclose(final_mse, min(scores), rtol=1e-6)


def test_early_stopping_caps_epochs():
    x, y, w = make_data(64)
    # validation on pure noise: val MSE will not improve for long
    rng = np.random.default_rng(2)
    xv = rng.uniform(-1, 1, (32, 4))
    yv = rng.normal(size=32) * 100.0
    config = MLPConfig(
        input_dim=4, hidden_dims=[4], learning_rate=1e-5, batch_size=32,
        n_epochs=200,
    )
    scores, _, _ = train_mlp(config, x, y, x_val=xv, y_val=yv, seed=0)
    assert len(scores) < 200, "early stopping never triggered"


def test_unweighted_training_runs():
    x, y, _ = make_data(128)
    config = MLPConfig(input_dim=4, hidden_dims=[8], n_epochs=3, batch_size=32)
    scores, compr2, model = train_mlp(config, x, y)
    assert scores == [] and compr2 == []  # no validation set
    assert mlp_predict(model, x).shape == (128, 1)


def test_train_without_validation_set_keeps_learned_weights():
    """Regression: without a validation set, `best` was never reassigned
    and the post-loop restore returned the untrained init network."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (256, 3))
    y = x @ np.array([1.0, -2.0, 0.5]) + 0.3
    config = MLPConfig(
        input_dim=3, hidden_dims=[16], learning_rate=1e-2,
        batch_size=64, n_epochs=30,
    )
    scores, _, model = train_mlp(config, x, y)
    pred = np.asarray(mlp_predict(model, x)).ravel()
    mse = float(np.mean((pred - y) ** 2))
    assert mse < 0.1 * float(np.var(y)), mse


def test_validation_training_actually_reduces_val_mse():
    """Regression: the plateau transform was stepped per mini-batch with a
    0.0-seeded best value, collapsing the lr within one epoch; per-epoch
    scheduling must let easy data train to low validation MSE."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (400, 2))
    y = 2.0 * x[:, 0] - x[:, 1]
    xv = rng.uniform(-1, 1, (100, 2))
    yv = 2.0 * xv[:, 0] - xv[:, 1]
    config = MLPConfig(
        input_dim=2, hidden_dims=[16], learning_rate=1e-2,
        batch_size=64, n_epochs=40,
    )
    scores, _, model = train_mlp(config, x, y, x_val=xv, y_val=yv)
    assert scores[-1] < 0.1 * float(np.var(yv)), scores[-5:]
    assert min(scores) < scores[0]
