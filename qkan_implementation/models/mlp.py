"""MLP comparison baseline: BatchNorm -> (Dense -> tanh)* -> Dense.

JAX rebuild of ``train_utils.train_mlp`` (reference
``train_utils.py:10-133``): Adam lr 8e-5 with a reduce-on-plateau schedule
(factor 0.5, patience 2), global-norm gradient clipping at 1.0, weighted MSE
loss, early stopping with patience 10 and best-state restore, returning
per-epoch validation MSE and weighted competition-R^2 traces.  Training steps
are jit-compiled; the duplicated best-model bookkeeping of the reference
(train_utils.py:105-119) is not replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from qkan_implementation.utils.metrics import weighted_competition_r2

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1  # torch BatchNorm1d default


@dataclass
class MLPConfig:
    input_dim: int
    hidden_dims: List[int]
    output_dim: int = 1
    learning_rate: float = 8e-5
    batch_size: int = 32
    n_epochs: int = 10


def init_mlp(config: MLPConfig, seed: int = 0, dtype=jnp.float32):
    """He-style init; returns (params, bn_state)."""
    key = jax.random.key(seed)
    dims = [config.input_dim, *config.hidden_dims, config.output_dim]
    layers = []
    for i in range(len(dims) - 1):
        key, sub = jax.random.split(key)
        bound = 1.0 / np.sqrt(dims[i])
        w = jax.random.uniform(
            sub, (dims[i], dims[i + 1]), minval=-bound, maxval=bound, dtype=dtype
        )
        b = jnp.zeros(dims[i + 1], dtype=dtype)
        layers.append({"w": w, "b": b})
    params = {
        "bn_scale": jnp.ones(config.input_dim, dtype=dtype),
        "bn_bias": jnp.zeros(config.input_dim, dtype=dtype),
        "layers": layers,
    }
    bn_state = {
        "mean": jnp.zeros(config.input_dim, dtype=dtype),
        "var": jnp.ones(config.input_dim, dtype=dtype),
    }
    return params, bn_state


def mlp_apply(params, bn_state, x, train: bool):
    """Forward pass; returns (output, new_bn_state)."""
    if train:
        mean = jnp.mean(x, axis=0)
        var = jnp.var(x, axis=0)
        n = x.shape[0]
        unbiased = var * n / max(n - 1, 1)
        new_state = {
            "mean": (1 - _BN_MOMENTUM) * bn_state["mean"] + _BN_MOMENTUM * mean,
            "var": (1 - _BN_MOMENTUM) * bn_state["var"] + _BN_MOMENTUM * unbiased,
        }
    else:
        mean, var = bn_state["mean"], bn_state["var"]
        new_state = bn_state
    h = (x - mean) / jnp.sqrt(var + _BN_EPS)
    h = h * params["bn_scale"] + params["bn_bias"]
    layers = params["layers"]
    for layer in layers[:-1]:
        h = jnp.tanh(h @ layer["w"] + layer["b"])
    out = h @ layers[-1]["w"] + layers[-1]["b"]
    return out, new_state


def train_mlp(
    config: MLPConfig,
    x_train,
    y_train,
    weights=None,
    x_val=None,
    y_val=None,
    w_val=None,
    seed: int = 0,
    verbose: bool = False,
):
    """Train the MLP baseline; returns (scores, compr2_scores, model).

    ``scores``/``compr2_scores`` are the per-epoch validation MSE and
    weighted competition-R^2 lists the reference returns
    (train_utils.py:99-133).  ``model`` is a dict {params, bn_state, config}
    usable with ``mlp_apply(..., train=False)``.
    """
    import optax

    x = jnp.asarray(x_train)
    y = jnp.asarray(y_train).reshape(-1, 1)
    w = None
    if weights is not None:
        w = jnp.asarray(weights).reshape(-1, 1)
        w = w / jnp.mean(w)  # normalize like the reference (train_utils.py:19-20)

    params, bn_state = init_mlp(config, seed=seed, dtype=x.dtype)

    tx = optax.chain(
        optax.clip_by_global_norm(1.0),  # train_utils.py:42
        optax.adam(config.learning_rate),
    )
    opt_state = tx.init(params)
    # ReduceLROnPlateau(factor=0.5, patience=2) stepped ONCE PER EPOCH on
    # the validation loss (train_utils.py:39), exactly like the reference --
    # implemented as a per-epoch lr scale below.  (Stepping a plateau
    # transform per mini-batch with a pre-seeded value poisons its best
    # tracker and collapses the lr within one epoch.)

    def loss_fn(params, bn_state, xb, yb, wb):
        pred, new_state = mlp_apply(params, bn_state, xb, train=True)
        if wb is not None:
            loss = jnp.mean(wb * (pred - yb) ** 2)
        else:
            loss = jnp.mean((pred - yb) ** 2)
        return loss, new_state

    # One scan program per epoch (not a host dispatch + loss
    # fetch per step): identical per-batch updates, losses fetched once per
    # epoch.  Same structure as FixedKAN.train.
    @partial(jax.jit, static_argnames=("weighted",))
    def epoch_fn(params, bn_state, opt_state, idx_mat, lr_scale, weighted):
        def train_step(carry, idx_row):
            params, bn_state, opt_state = carry
            xb = jnp.take(x, idx_row, axis=0)
            yb = jnp.take(y, idx_row, axis=0)
            wb = jnp.take(wb_dummy, idx_row, axis=0)
            (loss, new_state), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params, bn_state, xb, yb, wb if weighted else None)
            updates, opt_state = tx.update(grads, opt_state, params)
            updates = jax.tree.map(lambda u: u * lr_scale, updates)
            params = optax.apply_updates(params, updates)
            return (params, new_state, opt_state), loss

        (params, bn_state, opt_state), ls = jax.lax.scan(
            train_step, (params, bn_state, opt_state), idx_mat
        )
        return params, bn_state, opt_state, ls

    eval_fn = jax.jit(lambda p, s, xv: mlp_apply(p, s, xv, train=False)[0])

    n = x.shape[0]
    batch_size = min(config.batch_size, n)
    steps = max(1, n // batch_size)
    rng = np.random.default_rng(seed)
    scores, compr2_scores = [], []
    best_val = np.inf
    best = None  # only meaningful with a validation set
    patience_counter = 0
    lr_scale = jnp.asarray(1.0, dtype=x.dtype)
    sched_best = np.inf  # plateau scheduler state (per-epoch)
    sched_wait = 0
    weighted = w is not None
    wb_dummy = w if weighted else jnp.zeros_like(y)

    for epoch in range(config.n_epochs):
        perm = rng.permutation(n)[: steps * batch_size]
        idx_mat = jnp.asarray(perm.reshape(steps, batch_size), dtype=jnp.int32)
        params, bn_state, opt_state, ls = epoch_fn(
            params, bn_state, opt_state, idx_mat, lr_scale, weighted
        )
        total = float(np.sum(np.asarray(ls, dtype=np.float64)))

        sched_metric = None  # reference only steps the scheduler on val MSE
        if x_val is not None and y_val is not None:
            xv = jnp.asarray(x_val)
            yv = jnp.asarray(y_val).reshape(-1, 1)
            pred = eval_fn(params, bn_state, xv)
            val_mse = float(jnp.mean((pred - yv) ** 2))
            sched_metric = val_mse
            scores.append(val_mse)
            if w_val is not None:
                wv = jnp.asarray(w_val).reshape(-1)
                wv = wv / jnp.mean(wv)
                compr2_scores.append(
                    weighted_competition_r2(yv, pred, wv)
                )
            if val_mse < best_val:
                best_val = val_mse
                best = (params, bn_state)
                patience_counter = 0
            else:
                patience_counter += 1
            if patience_counter >= 10:  # early stopping, train_utils.py:45-47
                if verbose:
                    print(f"Early stopping triggered at epoch {epoch}")
                break
        # per-epoch plateau lr schedule (factor 0.5, patience 2).  The
        # reference calls scheduler.step(val_mse) only inside its validation
        # branch (train_utils.py:126) -- without val data the LR never
        # decays -- and ReduceLROnPlateau's default threshold is a RELATIVE
        # 1e-4 improvement, not an absolute epsilon.
        if sched_metric is not None:
            if sched_metric < sched_best * (1 - 1e-4):
                sched_best = sched_metric
                sched_wait = 0
            else:
                sched_wait += 1
                if sched_wait >= 2:
                    lr_scale = lr_scale * 0.5
                    sched_wait = 0
        if verbose:
            msg = f"Epoch {epoch}, Loss: {total/steps:.4f}"
            if scores:
                msg += f", Val MSE: {scores[-1]:.4f}"
            if compr2_scores:
                msg += f", Val compR2: {compr2_scores[-1]:.4f}"
            print(msg)

    if best is not None:
        # best-state restore (train_utils.py:130-131); with no validation
        # set there is no selection signal -- keep the final weights
        # (restoring the pre-training init would discard all learning)
        params, bn_state = best
    model = {"params": params, "bn_state": bn_state, "config": config}
    return scores, compr2_scores, model


def mlp_predict(model: dict, x) -> jax.Array:
    return mlp_apply(model["params"], model["bn_state"], jnp.asarray(x), train=False)[0]
