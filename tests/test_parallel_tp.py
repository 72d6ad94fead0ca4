"""Tensor-parallel layer parity: parallel/tp.py vs the single-device path.

The reference has no model-parallel axis (single-process torch); these tests
pin that the Megatron-style row-parallel split (features + coefficient
``in`` axis over ``tp``, psum/psum_scatter reductions, dp-composed
gradients) is EXACT against ``kan_apply`` / a single-device SGD step under
x64 on the 8-virtual-device CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from qkan_implementation.models.fixed_kan import kan_apply
from qkan_implementation.parallel.tp import (
    kan_apply_tp,
    make_tp_train_step,
    shard_params,
)


def _params(seed, in_dim, outs, target_dim, max_degree):
    rng = np.random.default_rng(seed)
    params = []
    cur = in_dim
    for out in outs:
        params.append(
            {
                "degrees": jnp.asarray(
                    rng.integers(0, max_degree + 1, out), jnp.int32
                ),
                "coefficients": jnp.asarray(
                    rng.normal(size=(out, cur, max_degree + 1, target_dim))
                    * 0.3
                ),
                "horizontal_weights": jnp.asarray(rng.normal(size=out) + 1.0),
            }
        )
        cur = target_dim
    return params


@pytest.fixture(scope="module")
def mesh2d():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]).reshape(2, 4), ("dp", "tp"))


@pytest.fixture(scope="module")
def mesh1d():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:8]), ("tp",))


MAX_DEGREE = 3


def test_forward_parity_chained_sharded(mesh2d):
    # L0 in=8 (sharded over tp=4), L1 in=4 (sharded, psum_scatter chain)
    params = _params(0, 8, (6, 5), 4, MAX_DEGREE)
    x = jnp.asarray(np.random.default_rng(1).uniform(-2, 2, (8, 8)))
    ref = kan_apply(params, x, MAX_DEGREE)
    out = kan_apply_tp(params, x, MAX_DEGREE, mesh2d, dp_axis="dp")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


def test_forward_parity_replicated_then_sharded(mesh2d):
    # L0 in=6 (6 % 4 != 0 -> replicated), L1 in=4 (sharded): exercises the
    # replicated-output -> local-feature-slice transition
    params = _params(2, 6, (5, 7), 4, MAX_DEGREE)
    x = jnp.asarray(np.random.default_rng(3).uniform(-2, 2, (6, 6)))
    ref = kan_apply(params, x, MAX_DEGREE)
    out = kan_apply_tp(params, x, MAX_DEGREE, mesh2d, dp_axis="dp")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


def test_forward_parity_tp_only_mesh(mesh1d):
    params = _params(4, 16, (4,), 8, MAX_DEGREE)
    x = jnp.asarray(np.random.default_rng(5).uniform(-2, 2, (3, 16)))
    ref = kan_apply(params, x, MAX_DEGREE)
    out = kan_apply_tp(params, x, MAX_DEGREE, mesh1d, dp_axis=None)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


def test_shard_params_layout(mesh2d):
    params = _params(6, 8, (6, 5), 4, MAX_DEGREE)
    sharded = shard_params(params, 8, mesh2d, dp_axis="dp")
    c0 = sharded[0]["coefficients"]
    # in axis (8) split over tp=4 -> local shards carry 2 features
    shard_shapes = {s.data.shape for s in c0.addressable_shards}
    assert shard_shapes == {(6, 2, MAX_DEGREE + 1, 4)}
    # replicated leaves stay whole
    hw_shapes = {s.data.shape for s in sharded[0]["horizontal_weights"].addressable_shards}
    assert hw_shapes == {(6,)}
    out = kan_apply_tp(
        sharded,
        jnp.asarray(np.random.default_rng(7).uniform(-1, 1, (4, 8))),
        MAX_DEGREE,
        mesh2d,
        dp_axis="dp",
    )
    assert np.isfinite(np.asarray(out)).all()


def test_train_step_parity(mesh2d):
    params = _params(8, 8, (6, 5), 4, MAX_DEGREE)
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.uniform(-2, 2, (8, 8)))
    y = jnp.asarray(rng.normal(size=(8, 4)))
    lr = 0.05

    degrees = [lp["degrees"] for lp in params]
    train = [
        {k: v for k, v in lp.items() if k != "degrees"} for lp in params
    ]

    def ref_loss(tps):
        full = [dict(t, degrees=d) for t, d in zip(tps, degrees)]
        return jnp.mean((kan_apply(full, x, MAX_DEGREE) - y) ** 2)

    ref_l, ref_g = jax.value_and_grad(ref_loss)(train)
    ref_new = jax.tree.map(lambda p, g: p - lr * g, train, ref_g)

    step = make_tp_train_step(mesh2d, MAX_DEGREE, learning_rate=lr)
    new, loss = step(train, degrees, x, y)

    np.testing.assert_allclose(float(loss), float(ref_l), atol=1e-12)
    for got, want in zip(new, ref_new):
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), np.asarray(want[k]), atol=1e-10,
                err_msg=k,
            )


def test_train_step_descends(mesh2d):
    params = _params(10, 8, (4,), 4, MAX_DEGREE)
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.uniform(-2, 2, (16, 8)))
    y = jnp.asarray(rng.normal(size=(16, 4)))
    degrees = [lp["degrees"] for lp in params]
    train = [
        {k: v for k, v in lp.items() if k != "degrees"} for lp in params
    ]
    step = make_tp_train_step(mesh2d, MAX_DEGREE, learning_rate=0.05)
    losses = []
    for _ in range(5):
        train, loss = step(train, degrees, x, y)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_errors(mesh2d):
    params = _params(12, 8, (4,), 4, MAX_DEGREE)
    x = jnp.ones((5, 8))  # 5 % dp=2 != 0
    with pytest.raises(ValueError, match="not divisible"):
        kan_apply_tp(params, x, MAX_DEGREE, mesh2d, dp_axis="dp")
    with pytest.raises(ValueError, match="no model axis"):
        kan_apply_tp(
            params, jnp.ones((4, 8)), MAX_DEGREE, mesh2d, tp_axis="model"
        )


def test_train_step_parity_replicated_then_sharded(mesh2d):
    """Gradients through the replicated-output -> sharded-layer transition
    (the device-varying dynamic_slice of a tp-invariant value): its
    transpose must scatter-add the shard cotangents back, which only the
    vma machinery inserts.  L0 in=6 (replicated on tp=4) -> L1 in=4
    (sharded) must match dense gradients exactly."""
    params = _params(14, 6, (5, 4), 4, MAX_DEGREE)
    rng = np.random.default_rng(15)
    x = jnp.asarray(rng.uniform(-2, 2, (8, 6)))
    y = jnp.asarray(rng.normal(size=(8, 4)))
    lr = 0.05
    degrees = [lp["degrees"] for lp in params]
    train = [
        {k: v for k, v in lp.items() if k != "degrees"} for lp in params
    ]

    def ref_loss(tps):
        full = [dict(t, degrees=d) for t, d in zip(tps, degrees)]
        return jnp.mean((kan_apply(full, x, MAX_DEGREE) - y) ** 2)

    ref_l, ref_g = jax.value_and_grad(ref_loss)(train)
    ref_new = jax.tree.map(lambda p, g: p - lr * g, train, ref_g)

    step = make_tp_train_step(mesh2d, MAX_DEGREE, learning_rate=lr)
    new, loss = step(train, degrees, x, y)
    np.testing.assert_allclose(float(loss), float(ref_l), atol=1e-12)
    for got, want in zip(new, ref_new):
        for k in want:
            np.testing.assert_allclose(
                np.asarray(got[k]), np.asarray(want[k]), atol=1e-10,
                err_msg=k,
            )


def test_train_step_rejects_int8(mesh2d):
    # same guard as FixedKAN.train: rounded int8 operands have zero
    # tangent, so a train step through them silently mis-trains
    with pytest.raises(ValueError, match="int8"):
        make_tp_train_step(mesh2d, MAX_DEGREE, compute_dtype=jnp.int8)


def test_forward_precision_policy_uses_global_fanin(mesh1d):
    """The fan-in-aware precision policy must be decided on the GLOBAL
    contraction width, not the local shard's: a wide layer split 8-way can
    drop below the 512 threshold per-device while the psum'd contraction
    is still the width where TF32 cost test accuracy
    (benchmarks/eval_precision_probe.py).  Pinned structurally via the
    lowered HLO: the layer dot must carry the three-pass bf16 algorithm
    under tp."""
    # in=128, D+1=4: global fan-in 512 (>= threshold), local 64 (< it)
    params = _params(7, 128, (4,), 3, MAX_DEGREE)
    params = [
        {
            k: v.astype(jnp.float32) if k != "degrees" else v
            for k, v in lp.items()
        }
        for lp in params
    ]
    x = jnp.asarray(
        np.random.default_rng(8).uniform(-1, 1, (16, 128)), jnp.float32
    )
    low = jax.jit(
        lambda p, xb: kan_apply_tp(p, xb, MAX_DEGREE, mesh1d)
    ).lower(params, x).as_text()
    pinned = "num_primitive_operations = 3"
    assert pinned in low
    # and an explicit opt-out must NOT pin it
    low_none = jax.jit(
        lambda p, xb: kan_apply_tp(
            p, xb, MAX_DEGREE, mesh1d, matmul_precision=None
        )
    ).lower(params, x).as_text()
    assert pinned not in low_none


def test_int8_tp_warns_on_global_fanin(mesh1d):
    """The int8 chance-accuracy warning must fire on GLOBAL fan-in under
    tp: an 8-way shard of a 512-wide contraction sees only 64 local rows,
    below kan_layer_apply's local check, but the psum'd result is still
    the width where int8 measured chance accuracy (ADVICE r4)."""
    import warnings

    params = _params(7, 128, (4,), 3, MAX_DEGREE)  # global fan-in 512
    params = [
        {
            k: v.astype(jnp.float32) if k != "degrees" else v
            for k, v in lp.items()
        }
        for lp in params
    ]
    x = jnp.asarray(
        np.random.default_rng(8).uniform(-1, 1, (16, 128)), jnp.float32
    )
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        kan_apply_tp(params, x, MAX_DEGREE, mesh1d, compute_dtype=jnp.int8)
    assert any("GLOBAL fan-in 512" in str(x.message) for x in w)

    # narrow global fan-in: quiet
    params_n = _params(9, 32, (4,), 3, MAX_DEGREE)  # global fan-in 128
    params_n = [
        {
            k: v.astype(jnp.float32) if k != "degrees" else v
            for k, v in lp.items()
        }
        for lp in params_n
    ]
    x_n = jnp.asarray(
        np.random.default_rng(10).uniform(-1, 1, (16, 32)), jnp.float32
    )
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        kan_apply_tp(params_n, x_n, MAX_DEGREE, mesh1d, compute_dtype=jnp.int8)
    assert not any("int8 tp serving" in str(x.message) for x in w)
